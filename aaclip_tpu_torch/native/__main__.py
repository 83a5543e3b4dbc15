"""``python -m aaclip_tpu_torch.native``: build (or find) both host
libraries and print how each was built, or why it was not."""

from aaclip_tpu_torch.native import build

for name, load in (("fast_metrics", build.load),
                   ("fast_image", build.load_image_lib)):
    lib = load()
    where = f" -> {build.library_path(name)}" if lib is not None else ""
    print(f"{name}: {build.build_info().get(name)}{where}")
