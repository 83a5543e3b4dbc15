"""End-to-end smoke of the HTTP serving surface against a real server
process: spawn the port's server (``serve/server.py::main``), wait for
/healthz, POST PNG requests, check /statz consistency and 4xx on bad
input, then terminate; the JAX package's ``tools/serve_smoke.py`` on the
port.

The child is given its device explicitly: the device this tool resolves
(the card unless ``main(..., device=...)`` names another) is passed to
``main(argv, device=...)`` in the child; the server's flags are the JAX
server's. The PNG bodies are encoded by ``data/image.py`` (no PIL).

    python -u -m aaclip_tpu_torch.tools.serve_smoke       # production ViT-L
    python -u -m aaclip_tpu_torch.tools.serve_smoke \
        --model_name tiny-test --img_size 70 --tiny_adapters
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request

import numpy as np

# the directory that holds the package: the child imports it from there
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CHILD = ("import json, sys\n"
         "from aaclip_tpu_torch.serve.server import main\n"
         "main(json.loads(sys.argv[1]), device=sys.argv[2])\n")


def main(argv=None, *, device=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_name", default="ViT-L-14-336")
    p.add_argument("--img_size", type=int, default=518)
    p.add_argument("--precision", default="bf16")
    p.add_argument("--max_batch", type=int, default=8)
    p.add_argument("--port", type=int, default=8431)
    p.add_argument("--requests", type=int, default=4)
    p.add_argument("--startup_timeout", type=float, default=900.0)
    p.add_argument("--tiny_adapters", action="store_true",
                   help="small adapter config for tiny-test CPU runs")
    args = p.parse_args(argv)

    from aaclip_tpu_torch.data.image import encode_png
    from aaclip_tpu_torch.device import resolve_device

    dev = str(resolve_device(device))
    server_argv = ["--port", str(args.port),
                   "--model_name", args.model_name,
                   "--img_size", str(args.img_size),
                   "--precision", args.precision,
                   "--max_batch", str(args.max_batch)]
    if args.tiny_adapters:
        server_argv += ["--levels", "1", "2", "--image_adapt_until", "1",
                        "--text_adapt_until", "1"]
    # refuse to run against a stale server: if something already answers
    # on the port, the healthz poll below would validate the wrong process
    # while the new child dies unnoticed
    base_probe = f"http://127.0.0.1:{args.port}"
    try:
        urllib.request.urlopen(base_probe + "/healthz", timeout=2)
        live = True
    except urllib.error.HTTPError:
        live = True  # an HTTP error is still something answering
    except (urllib.error.URLError, ConnectionError, OSError):
        live = False  # nothing listening: good
    if live:
        raise SystemExit(
            f"something is already serving on port {args.port} — kill it "
            f"or pass a different --port")

    # child output goes to a file, never a pipe: this loop does not drain
    # a pipe while polling healthz, so a chatty start-up would fill its
    # buffer and block the server mid-start-up
    logf = tempfile.NamedTemporaryFile("w", suffix="_serve_smoke.log",
                                       delete=False)
    print(f"server log: {logf.name}", flush=True)
    proc = subprocess.Popen(
        [sys.executable, "-u", "-c", CHILD, json.dumps(server_argv), dev],
        cwd=ROOT, stdout=logf, stderr=subprocess.STDOUT, text=True)
    base = f"http://127.0.0.1:{args.port}"
    t0 = time.time()
    ok = False
    try:
        while True:
            if proc.poll() is not None:
                with open(logf.name) as f:
                    print(f.read()[-3000:])
                raise SystemExit("server exited during startup")
            try:
                health = json.load(urllib.request.urlopen(
                    base + "/healthz", timeout=2))
                break
            except Exception:
                time.sleep(2)
            if time.time() - t0 > args.startup_timeout:
                raise SystemExit("healthz timeout")
        print(f"healthz after {time.time() - t0:.0f}s: {health}", flush=True)

        rng = np.random.default_rng(0)
        classes = ["bottle", "cable"]
        for i in range(args.requests):
            img = (rng.random((args.img_size, args.img_size, 3)) * 255
                   ).astype(np.uint8)
            req = urllib.request.Request(
                base + f"/predict?dataset=MVTec&class_name="
                       f"{classes[i % 2]}&map_stride=64",
                data=encode_png(img), method="POST")
            t1 = time.time()
            r = json.load(urllib.request.urlopen(req, timeout=120))
            print(f"req{i} class={classes[i % 2]}: "
                  f"score={r['image_score']:.4f} "
                  f"map_rows={len(r['anomaly_map'])} "
                  f"untrained={r.get('untrained')} "
                  f"{(time.time() - t1) * 1e3:.0f}ms", flush=True)

        stats = json.load(urllib.request.urlopen(base + "/statz", timeout=10))
        print("statz:", stats, flush=True)
        # explicit raises, not asserts: python -O must not turn a failing
        # smoke into SERVE HTTP SMOKE OK
        if stats["requests"] < args.requests or stats["errors"] != 0:
            raise SystemExit(f"statz inconsistent: {stats}")

        try:
            urllib.request.urlopen(urllib.request.Request(
                base + "/predict?dataset=MVTec&class_name=nope",
                data=b"xx", method="POST"), timeout=30)
            raise SystemExit("expected an HTTP error for an unknown class")
        except urllib.error.HTTPError as e:
            if not 400 <= e.code < 500:
                raise SystemExit(
                    f"unknown class returned HTTP {e.code}, expected 4xx")
            print(f"unknown class -> HTTP {e.code} (expected 4xx)", flush=True)
        print("SERVE HTTP SMOKE OK")
        ok = True
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=15)
        logf.close()
        if ok:  # a failing run keeps its server log
            os.unlink(logf.name)


if __name__ == "__main__":
    main()
