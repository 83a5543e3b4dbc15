"""The port imports neither JAX nor the JAX package: its predict (with the
default block and with the fused block), its stage-2 training step (the
path of ``bench --mode train``) and its stage-1 features and step
(``bench --mode train_stage1``, tokenizer and prompts included) run in a
fresh interpreter without either entering
``sys.modules``, and no source file of the port (or chip_smoke.py, which
runs where JAX is absent) names them in an import. The evaluation CLI and
the training CLI (both stages, host and on-card augment) run on a PNG
dataset in an interpreter where PIL, pandas, scikit-learn and cv2 cannot
be imported (the card's machine may lack any of them): the evaluation
CLI on the host library (``native/``, its metrics and decode), the
training CLI also with ``--remat selective --fused_assemble
--cache_device``; so do the serving engine (a PNG request body decoded,
submitted, and served over HTTP), a memory-bank predict and ``python -m
aaclip_tpu_torch.serve --help``. So do the int8 predict (whole and mixed
prefix), an artifact's export (the deploy CLI with ``--verify``) and load,
and ``python -m aaclip_tpu_torch.deploy``. A data-parallel predict and
stage-2 step (``parallel/``) run at world size 1 on gloo (``torchrun``'s
variables set) in a fresh interpreter without either, where the pipeline's
mesh refuses a world of one. With PIL and cv2 blocked too, the package's
lazy re-exports resolve, ``AdaptedCLIP.create`` builds and runs, and
``eval/visualize.py`` writes a PNG panel."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|aaclip_tpu)\b"
                       r"(?!_torch)", re.MULTILINE)

PROBE = """
import json, sys
import numpy as np, torch
from aaclip_tpu_torch.core.config import AdapterConfig, DtypePolicy, get_config
from aaclip_tpu_torch.core.params import init_image_adapter, init_vision_params
from aaclip_tpu_torch.eval.predict import make_predict_fn
from aaclip_tpu_torch.ops.similarity import fused_postproc_matrix
from aaclip_tpu_torch.train.optim import make_image_optimizer
from aaclip_tpu_torch.train.steps import make_stage2_step
import aaclip_tpu_torch.bench, aaclip_tpu_torch.entry
cfg = get_config("tiny-test")
acfg = AdapterConfig(levels=(1, 2), image_adapt_until=1)
vit = init_vision_params(cfg, device="cpu")
ad = init_image_adapter(cfg, acfg, device="cpu")
p = make_predict_fn(vit, cfg, acfg, policy=DtypePolicy.bf16(),
                    uint8_inputs=True, device="cpu")
x = torch.zeros(2, 3, 70, 70, dtype=torch.uint8)
a = torch.nn.functional.normalize(torch.ones(32, 2), dim=0)
M = torch.from_numpy(fused_postproc_matrix(5, 70, "Industrial"))
pix, score = p(ad, x, a, M)
from aaclip_tpu_torch.models.layers import config_act
from aaclip_tpu_torch.ops.fused_block import make_block_fn
bf = DtypePolicy.bf16()
pf = make_predict_fn(vit, cfg, acfg, policy=bf, uint8_inputs=True,
                     device="cpu", block_fn=make_block_fn(
                         cfg.vision.heads, bf, act=config_act(cfg, bf)))
fpix, fscore = pf(ad, x, a, M)
step = make_stage2_step(vit, cfg, acfg, make_image_optimizer(ad.parameters()),
                        torch.stack([a, a]), policy=DtypePolicy.bf16(),
                        remat=False, device="cpu")
loss = step(ad, x.float(), torch.zeros(2, 70, 70), torch.tensor([0, 1]),
            torch.tensor([0, 1]), torch.ones(2))
from aaclip_tpu_torch.core.params import init_text_adapter, init_text_params
from aaclip_tpu_torch.text.anchors import dataset_prompt_tokens
from aaclip_tpu_torch.train.optim import make_text_optimizer
from aaclip_tpu_torch.train.steps import make_stage1_step, stage1_features_fn
tacfg = AdapterConfig(levels=(1, 2), image_adapt_until=1, text_adapt_until=1)
text = init_text_params(cfg, device="cpu")
tad = init_text_adapter(cfg, tacfg, device="cpu")
feats = stage1_features_fn(vit, cfg, surgery_until_layer=2, vv_mode="spatial",
                           policy=DtypePolicy.bf16(), device="cpu")(
    x.float())
s1 = make_stage1_step(text, cfg, tacfg, make_text_optimizer(tad.parameters()),
                      dataset_prompt_tokens("MVTec", ["bottle", "cable"]),
                      policy=DtypePolicy.bf16(), device="cpu")
loss1 = s1(tad, feats, torch.zeros(2, 70, 70), torch.tensor([0, 1]),
           torch.ones(2))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "aaclip_tpu"))
print(json.dumps({"bad": bad, "shape": list(pix.shape),
                  "fused_shape": list(fpix.shape),
                  "feats": list(feats.shape),
                  "finite": bool(torch.isfinite(pix).all()
                                 and torch.isfinite(fpix).all()
                                 and torch.isfinite(loss)
                                 and torch.isfinite(feats).all()
                                 and torch.isfinite(loss1))}))
"""


def test_predict_runs_without_jax_in_a_fresh_interpreter():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result == {"bad": [], "shape": [2, 70, 70],
                      "fused_shape": [2, 70, 70], "feats": [2, 25, 32],
                      "finite": True}


PARALLEL_PROBE = """
import json, os, sys
os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                  MASTER_ADDR="127.0.0.1", MASTER_PORT=sys.argv[1])
import torch
import torch.distributed as dist
from aaclip_tpu_torch.core.config import AdapterConfig, DtypePolicy, get_config
from aaclip_tpu_torch.core.params import init_image_adapter, init_vision_params
from aaclip_tpu_torch.eval.predict import make_predict_fn
from aaclip_tpu_torch.ops.similarity import fused_postproc_matrix
from aaclip_tpu_torch.parallel import sharding as sh
from aaclip_tpu_torch.train.optim import make_image_optimizer
from aaclip_tpu_torch.train.steps import make_stage2_step
assert sh.initialize_multihost(device="cpu")
mesh = sh.make_data_mesh(device="cpu")
cfg = get_config("tiny-test")
acfg = AdapterConfig(levels=(1, 2), image_adapt_until=1)
vit = init_vision_params(cfg, device="cpu")
ad = init_image_adapter(cfg, acfg, device="cpu")
pol = DtypePolicy.fp32()
x = torch.randn(2, 3, 70, 70, generator=torch.Generator().manual_seed(0))
a = torch.nn.functional.normalize(torch.ones(32, 2), dim=0)
M = torch.from_numpy(fused_postproc_matrix(5, 70, "Industrial"))
pix, score = make_predict_fn(vit, cfg, acfg, policy=pol, mesh=mesh)(
    ad, x, a, M)
pix1, score1 = make_predict_fn(vit, cfg, acfg, policy=pol, device="cpu")(
    ad, x, a, M)
batch = (x, torch.zeros(2, 70, 70), torch.tensor([0, 1]),
         torch.tensor([0, 1]), torch.ones(2))
losses = []
for m in (mesh, None):
    ad2 = init_image_adapter(cfg, acfg, device="cpu")
    step = make_stage2_step(vit, cfg, acfg,
                            make_image_optimizer(ad2.parameters()),
                            torch.stack([a, a]), policy=pol, remat=False,
                            mesh=m, device=None if m else "cpu")
    losses.append(float(step(ad2, *batch)))
from aaclip_tpu_torch.parallel import pipeline as ppl
try:
    ppl.make_pp_mesh(2, device="cpu")
    pp_error = None
except ValueError as e:
    pp_error = str(e)
dist.destroy_process_group()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "aaclip_tpu"))
print(json.dumps({"bad": bad, "shape": list(pix.shape),
                  "same_predict": bool(torch.equal(pix, pix1)
                                       and torch.equal(score, score1)),
                  "same_loss": losses[0] == losses[1],
                  "pp_error": pp_error}))
"""


def test_parallel_paths_run_without_jax_at_world_one():
    """A data-parallel predict and stage-2 step at world size 1 on gloo:
    bit for bit the single-process ones, and no JAX imported."""
    from tests.torch_parallel_worker import free_port

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", PARALLEL_PROBE,
                          str(free_port())], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result == {"bad": [], "shape": [2, 70, 70], "same_predict": True,
                      "same_loss": True,
                      "pp_error": "pipeline_parallel=2 needs 2..1 devices"}


def test_sources_do_not_import_jax_or_the_jax_package():
    files = sorted((REPO / "aaclip_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    assert {"steps.py", "optim.py", "cli.py", "checkpoint.py"} <= {
        f.name for f in files if f.parent.name == "train"}
    assert {"augment.py", "device_cache.py", "transforms.py"} <= {
        f.name for f in files}
    assert {"text_model.py", "anchors.py", "bpe.py", "registry.py"} <= {
        f.name for f in files}
    assert {"server.py", "__main__.py", "__init__.py"} <= {
        f.name for f in files if f.parent.name == "serve"}
    assert {"memory_bank.py", "hashing.py", "deploy.py", "quant.py"} <= {
        f.name for f in files}
    assert {"__init__.py", "sharding.py", "tensor.py", "pipeline.py"} <= {
        f.name for f in files if f.parent.name == "parallel"}
    assert "visualize.py" in {f.name for f in files
                              if f.parent.name == "eval"}
    assert "clip.py" in {f.name for f in files if f.parent.name == "models"}
    worker = REPO / "tests" / "torch_parallel_worker.py"
    assert not FORBIDDEN.findall(worker.read_text())  # spawned ranks
    offenders = {str(f.relative_to(REPO)): FORBIDDEN.findall(f.read_text())
                 for f in files}
    assert not {f: m for f, m in offenders.items() if m}


def test_forbidden_pattern_catches_what_it_should():
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert FORBIDDEN.search("    from aaclip_tpu.ops import blur")
    assert FORBIDDEN.search("import aaclip_tpu")
    assert not FORBIDDEN.search("from aaclip_tpu_torch.ops import blur")
    assert not FORBIDDEN.search("import jaxtyping")


CLI_PROBE = """
import json, os, sys, tempfile
for name in ("PIL", "pandas", "sklearn", "cv2"):
    sys.modules[name] = None  # any import of them raises
from aaclip_tpu_torch.core.config import AdapterConfig, get_config
from aaclip_tpu_torch.core.params import (adapter_to_jax, init_image_adapter,
                                          init_text_adapter,
                                          text_adapter_to_jax)
from aaclip_tpu_torch.data.synthetic import make_synthetic_dataset
from aaclip_tpu_torch.train import checkpoint as ckpt
from aaclip_tpu_torch import test
root = tempfile.mkdtemp()
data_root, meta_root = make_synthetic_dataset(root, img_px=48)
os.environ.update(AACLIP_DATA=data_root, AACLIP_METADATA=meta_root)
cfg = get_config("tiny-test")
acfg = AdapterConfig(levels=(1, 2), image_adapt_until=1, text_adapt_until=1)
save = os.path.join(root, "ckpt")
ckpt.save_adapter_checkpoint(
    os.path.join(save, "image_adapter_1.npz"), 1,
    adapter_to_jax(init_image_adapter(cfg, acfg, device="cpu")))
ckpt.save_adapter_checkpoint(
    os.path.join(save, "text_adapter.npz"), 0,
    text_adapter_to_jax(init_text_adapter(cfg, acfg, device="cpu")))
test.main(["--model_name", "tiny-test", "--img_size", "70",
           "--text_adapt_until", "1", "--image_adapt_until", "1",
           "--levels", "1", "2", "--batch_size", "4", "--precision", "bf16",
           "--save_path", save, "--aupro", "--csv", "--dump_scores"],
          device="cpu")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "aaclip_tpu"))
rows = open(os.path.join(save, "results_1.csv")).read().splitlines()
from aaclip_tpu_torch import native
host = [l for l in open(os.path.join(save, "test.log")).read().splitlines()
        if "host paths:" in l]
print(json.dumps({"bad": bad, "rows": [r.split(",")[0] for r in rows],
                  "metrics": native.metrics_path(), "host": host}))
"""


def test_eval_cli_runs_without_pil_pandas_sklearn_cv2_or_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", CLI_PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    from aaclip_tpu_torch import native

    host = result.pop("host")
    assert result == {"bad": [], "rows": ["class name", "bottle", "cable",
                                          "Average"],
                      "metrics": native.metrics_path()}
    assert len(host) == 1 and f"metrics {native.metrics_path()} " in host[0]


TRAIN_PROBE = """
import json, os, sys, tempfile
for name in ("PIL", "pandas", "sklearn", "cv2"):
    sys.modules[name] = None  # any import of them raises
from aaclip_tpu_torch.data.synthetic import make_synthetic_dataset
from aaclip_tpu_torch.train import cli
root = tempfile.mkdtemp()
data_root, meta_root = make_synthetic_dataset(root, img_px=48)
os.environ.update(AACLIP_DATA=data_root, AACLIP_METADATA=meta_root)
argv = ["--model_name", "tiny-test", "--img_size", "70",
        "--text_adapt_until", "1", "--image_adapt_until", "1",
        "--levels", "1", "2", "--dataset", "MVTec", "--training_mode",
        "full_shot", "--surgery_until_layer", "2", "--text_batch_size", "4",
        "--image_batch_size", "4", "--text_epoch", "1", "--image_epoch", "1"]
for extra in ([], ["--device_augment", "--cache_device"],
              ["--device_augment", "--cache_device", "--fused_assemble",
               "--remat", "selective"]):
    save = os.path.join(root, "ckpt" + str(len(extra)))
    cli.main(argv + extra + ["--save_path", save], device="cpu")
log = open(os.path.join(save, "train.log")).read()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "aaclip_tpu"))
print(json.dumps({"bad": bad, "files": sorted(os.listdir(save)),
                  "selective": "stage 2 selective" in log,
                  "fused": "fused_assemble: batch k+1" in log}))
"""


def test_train_cli_runs_without_pil_pandas_sklearn_cv2_or_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", TRAIN_PROBE], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result == {"bad": [], "files": [
        "image_adapter.npz", "image_adapter_1.npz", "text_adapter.npz",
        "train.log"], "selective": True, "fused": True}


SERVE_PROBE = """
import contextlib, io, json, sys, threading, urllib.request
for name in ("PIL", "pandas", "sklearn", "cv2"):
    sys.modules[name] = None  # any import of them raises
import numpy as np, torch
from aaclip_tpu_torch.core.config import AdapterConfig, DtypePolicy, get_config
from aaclip_tpu_torch.core.params import init_image_adapter, init_vision_params
from aaclip_tpu_torch.data.image import encode_png
from aaclip_tpu_torch.eval import memory_bank as mb
from aaclip_tpu_torch.ops.similarity import fused_postproc_matrix
from aaclip_tpu_torch.serve import server
from aaclip_tpu_torch.serve.server import InferenceEngine, serve
eng = InferenceEngine(model_name="tiny-test", img_size=70, max_batch=2,
                      precision="bf16", device="cpu", adapter_cfg=dict(
                          levels=(1, 2), image_adapt_until=1,
                          text_adapt_until=1))
png = encode_png(np.random.default_rng(0).integers(0, 256, (40, 50, 3),
                                                   dtype=np.uint8))
amap, score = eng.submit(server._decode_image(png, 70), "MVTec", "bottle")
httpd = serve(eng, "127.0.0.1", 0)
threading.Thread(target=httpd.serve_forever, daemon=True).start()
req = urllib.request.Request(
    f"http://127.0.0.1:{httpd.server_address[1]}/predict?dataset=MVTec"
    "&class_name=cable&map_stride=7", data=png, method="POST")
with urllib.request.urlopen(req, timeout=60) as r:
    http_shape = json.loads(r.read())["map_shape"]
httpd.shutdown()
eng.shutdown()
cfg = get_config("tiny-test")
acfg = AdapterConfig(levels=(1, 2), image_adapt_until=1)
vit = init_vision_params(cfg, device="cpu")
ad = init_image_adapter(cfg, acfg, device="cpu")
p = mb.make_mb_predict_fn(vit, cfg, acfg, policy=DtypePolicy.bf16(),
                          uint8_inputs=True, device="cpu")
x = torch.randint(0, 256, (2, 3, 70, 70), dtype=torch.uint8)
bank = mb.collect_bank(p.features_fn, ad, x)
a = torch.nn.functional.normalize(torch.ones(32, 2), dim=0)
pix, s = p(ad, x, a, torch.from_numpy(fused_postproc_matrix(5, 70,
                                                            "Industrial")),
           bank)
out = io.StringIO()
with contextlib.redirect_stdout(out):
    try:
        server.main(["--help"])
    except SystemExit as e:
        code = e.code
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "aaclip_tpu"))
print(json.dumps({"bad": bad, "map": list(amap.shape), "http": http_shape,
                  "mb": list(pix.shape), "bank": list(bank.shape),
                  "finite": bool(np.isfinite(amap).all()
                                 and torch.isfinite(pix).all()),
                  "help": code == 0 and "--anchor_cache" in out.getvalue()}))
"""


def test_serving_and_memory_bank_run_without_pil_pandas_sklearn_cv2_or_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", SERVE_PROBE], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result == {"bad": [], "map": [70, 70], "http": [10, 10],
                      "mb": [2, 70, 70], "bank": [2, 50, 32],
                      "finite": True, "help": True}
    help_out = subprocess.run(
        [sys.executable, "-m", "aaclip_tpu_torch.serve", "--help"], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=120)
    assert help_out.returncode == 0 and "--anchor_cache" in help_out.stdout


INT8_PROBE = """
import dataclasses, json, sys
import torch
from aaclip_tpu_torch.core.config import AdapterConfig, DtypePolicy, get_config
from aaclip_tpu_torch.core.params import init_image_adapter, init_vision_params
from aaclip_tpu_torch.eval.predict import make_predict_fn
from aaclip_tpu_torch.ops.quant import qdot
from aaclip_tpu_torch.ops.similarity import fused_postproc_matrix
cfg = get_config("tiny-test")
acfg = AdapterConfig(levels=(1, 2), image_adapt_until=1)
vit = init_vision_params(cfg, device="cpu")
ad = init_image_adapter(cfg, acfg, device="cpu")
x = torch.zeros(2, 3, 70, 70, dtype=torch.uint8)
a = torch.nn.functional.normalize(torch.ones(32, 2), dim=0)
M = torch.from_numpy(fused_postproc_matrix(5, 70, "Industrial"))
shapes = []
for until in (0, 1):
    p = make_predict_fn(vit, cfg, acfg, uint8_inputs=True, device="cpu",
                        policy=dataclasses.replace(DtypePolicy.int8(),
                                                   int8_until=until))
    pix, score = p(ad, x, a, M)
    shapes.append(list(pix.shape))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "aaclip_tpu"))
print(json.dumps({"bad": bad, "shapes": shapes, "qdot": qdot.launches,
                  "finite": bool(torch.isfinite(pix).all())}))
"""

ARTIFACT_PROBE = """
import json, sys, tempfile
for name in ("PIL", "pandas", "sklearn", "cv2"):
    sys.modules[name] = None  # any import of them raises
import numpy as np
from aaclip_tpu_torch import deploy
out = tempfile.mkdtemp()
deploy.main(["--out", out, "--model_name", "tiny-test", "--img_size", "70",
             "--precision", "int8", "--levels", "1", "2",
             "--image_adapt_until", "1", "--text_adapt_until", "1",
             "--batch_sizes", "2", "--verify"], device="cpu")
art = deploy.load_serving_artifact(out, device="cpu")
imgs = np.zeros((3, 3, 70, 70), np.uint8)
maps, scores = art.predict_class(imgs, "MVTec", "bottle")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "aaclip_tpu"))
print(json.dumps({"bad": bad, "maps": list(maps.shape),
                  "finite": bool(np.isfinite(maps).all())}))
"""


def _fresh(code_or_args, **kw):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    argv = ([sys.executable, "-c", code_or_args]
            if isinstance(code_or_args, str) else
            [sys.executable] + code_or_args)
    return subprocess.run(argv, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300, **kw)


def test_int8_predict_runs_without_jax_in_a_fresh_interpreter():
    out = _fresh(INT8_PROBE)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    # 4 int8 products per block: 2 blocks, then block 0 alone
    assert result == {"bad": [], "shapes": [[2, 70, 70], [2, 70, 70]],
                      "qdot": 12, "finite": True}


def test_artifact_export_and_load_run_without_jax_in_a_fresh_interpreter():
    out = _fresh(ARTIFACT_PROBE)
    assert out.returncode == 0, out.stderr
    assert "verify OK" in out.stdout
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result == {"bad": [], "maps": [3, 70, 70], "finite": True}


def test_deploy_module_runs_without_jax(tmp_path):
    """``python -m aaclip_tpu_torch.deploy``: its help, and without a card
    an export raises (the CLI runs on the card, never on the CPU by
    default)."""
    help_out = _fresh(["-m", "aaclip_tpu_torch.deploy", "--help"])
    assert help_out.returncode == 0 and "--verify" in help_out.stdout
    if torch_cuda_available():
        return
    run = _fresh(["-m", "aaclip_tpu_torch.deploy", "--out",
                  str(tmp_path / "art"), "--model_name", "tiny-test"])
    assert run.returncode != 0 and "no CUDA device" in run.stderr


def torch_cuda_available() -> bool:
    import torch

    return torch.cuda.is_available()


FACADE_PROBE = """
import json, os, sys
for name in ("PIL", "cv2", "pandas", "sklearn"):
    sys.modules[name] = None  # any import of them raises
import numpy as np, torch
import aaclip_tpu_torch as port
names = ("CLIPModel", "AdaptedCLIP", "get_config", "AdapterConfig",
         "DtypePolicy", "create_clip_params", "init_adapter_params",
         "tokenize")
lazy = [n for n in names if "aaclip_tpu_torch.models.clip" in sys.modules]
cfg = port.get_config("tiny-test")
acfg = port.AdapterConfig(levels=(1, 2), image_adapt_until=1,
                          text_adapt_until=1)
model = port.AdaptedCLIP.create(cfg, acfg, device="cpu")
seg, det = model(torch.zeros(1, 3, 70, 70))
img, txt, scale = model.clip(torch.zeros(1, 3, 70, 70),
                             torch.as_tensor(port.tokenize(["a bottle"])))
resolved = all(callable(getattr(port, n)) for n in names)
from aaclip_tpu_torch.data.image import encode_png, load_rgb
from aaclip_tpu_torch.eval.visualize import visualize
root = sys.argv[1]
os.environ["AACLIP_DATA"] = root
from aaclip_tpu_torch.data.registry import DATASETS
d = os.path.join(DATASETS["MVTec"].data_path, "bottle", "test", "good")
os.makedirs(d)
with open(os.path.join(d, "000.png"), "wb") as f:
    f.write(encode_png(np.full((20, 30, 3), 90, np.uint8)))
visualize(np.zeros((1, 70, 70)), np.random.rand(1, 70, 70),
          ["bottle/test/good/000.png"], root, "MVTec", "bottle")
panel = load_rgb(os.path.join(root, "visualization", "MVTec", "bottle",
                              "bottle_test_good_000.png"))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "aaclip_tpu"))
print(json.dumps({"bad": bad, "lazy": lazy, "resolved": resolved,
                  "seg": list(seg[0].shape), "scale": round(float(scale), 4),
                  "panel": list(panel.shape)}))
"""


def test_visualize_and_facades_run_without_cv2_pil_or_jax(tmp_path):
    """With PIL and cv2 (and pandas, scikit-learn) blocked, importing the
    package loads none of the re-exported modules, the eight names
    resolve, ``AdaptedCLIP`` builds and runs, and a PNG panel is written;
    neither JAX nor the JAX package is imported."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", FACADE_PROBE,
                          str(tmp_path)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result == {"bad": [], "lazy": [], "resolved": True,
                      "seg": [1, 25, 32], "scale": round(1 / 0.07, 4),
                      "panel": [210, 70, 3]}
