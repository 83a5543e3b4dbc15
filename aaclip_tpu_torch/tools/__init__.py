"""The practitioner tools, each run as ``python -m
aaclip_tpu_torch.tools.<name>`` with the JAX package's ``tools/<name>.py``
flags, defaults and outputs, on the port's CLIs and library:
``predict_folder`` (a folder of images to scores and heatmaps),
``make_few_shot``, ``few_shot_soak``, ``precision_ab`` (and its
``int8_ab`` shim), ``export_torch_ckpt``, ``compare_golden`` and
``serve_smoke``. Each ``main(argv=None, *, device=None)`` runs on the
card unless ``device`` names another (the tests pass ``"cpu"``).
``make_few_shot``, ``compare_golden`` and ``export_torch_ckpt`` touch no
device: they take ``device`` so that every tool is called alike, and
ignore it."""
