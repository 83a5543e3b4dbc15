"""The port's serving engine and HTTP server (``aaclip_tpu_torch/serve/``)
against the JAX package's (``aaclip_tpu/serve/server.py``) on the CPU:
tiny-test, fp32, img 70, levels (1, 2), both engines from one
OpenAI-layout checkpoint the test writes (at a 4x4 grid; both loaders
resize the positional embedding to 5x5) and one image-adapter npz, with
the frozen text encoder's anchors.

Bars: the engines' maps and scores on the same submits within atol 1e-4
(fp32 through both towers in another summation order), their anchors
within 1e-5. Over HTTP the same bar plus each encoding's own rounding on
each side: JSON maps are rounded to 4 decimals (bar 1e-4 + 1e-4), f16
maps to half a float16 ulp (bar 1e-4 + one ulp at the map's largest
value), u8 maps to half their X-Map-Scale (bar 1e-4 + both half-scales);
scores ride the body or X-Image-Score unrounded (1e-4). Inside the port:
a mixed-class batch equals sequential submits (atol 1e-5, scores 1e-6, as
JAX's own test), a stride-s map equals the same batch's full map sliced
exactly, and the error paths give JAX's exceptions and HTTP codes.
"""

import json
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from aaclip_tpu.core.config import get_config as jax_get_config
from aaclip_tpu.serve import server as jsrv
from aaclip_tpu_torch.core.config import AdapterConfig, get_config
from aaclip_tpu_torch.core.params import (adapter_to_jax, init_image_adapter,
                                          init_text_adapter,
                                          text_adapter_to_jax)
from aaclip_tpu_torch.data.image import encode_png
from aaclip_tpu_torch.serve import server as psrv
from aaclip_tpu_torch.train import checkpoint as ckpt
from tests.test_model_parity import _make_state_dict

ATOL = 1e-4
ANCHOR_ATOL = 1e-5
ACFG = dict(levels=(1, 2), image_adapt_until=1, text_adapt_until=1)


def _engine_kwargs(ckpt_path, save_path, max_batch=4):
    return dict(model_name="tiny-test", img_size=70, datasets=("MVTec",),
                precision="fp32", max_batch=max_batch, adapter_cfg=ACFG,
                clip_checkpoint=ckpt_path, save_path=save_path)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    ckpt_path = str(root / "tiny.pt")
    torch.save(_make_state_dict(jax_get_config("tiny-test", 56), seed=5),
               ckpt_path)
    save = root / "adapters"
    cfg, acfg = get_config("tiny-test"), AdapterConfig(**ACFG)
    ckpt.save_adapter_checkpoint(
        str(save / "image_adapter_1.npz"), 1,
        adapter_to_jax(init_image_adapter(cfg, acfg, seed=3, device="cpu")))
    return ckpt_path, str(save)


@pytest.fixture(scope="module")
def engines(assets):
    kw = _engine_kwargs(*assets)
    jax_eng = jsrv.InferenceEngine(**kw)
    port_eng = psrv.InferenceEngine(**kw, device="cpu")
    yield jax_eng, port_eng
    jax_eng.shutdown()
    port_eng.shutdown()


def _start(engine, module):
    httpd = module.serve(engine, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def servers(engines):
    (jh, jurl), (ph, purl) = _start(engines[0], jsrv), _start(engines[1],
                                                              psrv)
    yield jurl, purl
    for h in (jh, ph):
        h.shutdown()
        h.server_close()


def _png(seed=0, size=48):
    rng = np.random.default_rng(seed)
    return encode_png((rng.random((size, size, 3)) * 255).astype(np.uint8))


def _request(url, data=None):
    """(status, headers, body) of a GET (no data) or POST."""
    req = urllib.request.Request(url, data=data,
                                 method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def _images(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (3, 70, 70), dtype=np.uint8)
            for _ in range(n)]


# -- the engines --------------------------------------------------------------


def test_engines_load_the_same_adapters_and_anchors(engines):
    jax_eng, port_eng = engines
    assert not jax_eng.untrained and not port_eng.untrained
    assert sorted(port_eng.anchors) == sorted(jax_eng.anchors) == ["MVTec"]
    assert sorted(port_eng.anchors["MVTec"]) == \
        sorted(jax_eng.anchors["MVTec"])
    for cls, want in jax_eng.anchors["MVTec"].items():
        got = port_eng.anchors["MVTec"][cls]
        assert isinstance(got, np.ndarray) and got.shape == (32, 2)
        np.testing.assert_allclose(got, np.asarray(want), atol=ANCHOR_ATOL,
                                   rtol=0)
    np.testing.assert_array_equal(port_eng.postproc["MVTec"],
                                  np.asarray(jax_eng.postproc["MVTec"]))
    assert set(port_eng.startup_s) == {"towers", "anchors", "warmup"}


@pytest.mark.parametrize("cls,stride", [("bottle", 1), ("cable", 1),
                                        ("screw", 7)])
def test_submit_matches_jax(engines, cls, stride):
    jax_eng, port_eng = engines
    for img in _images(1, 2):
        jm, js = jax_eng.submit(img, "MVTec", cls, map_stride=stride)
        pm, ps = port_eng.submit(img, "MVTec", cls, map_stride=stride)
        assert pm.shape == jm.shape == (-(-70 // stride),) * 2
        assert pm.dtype == np.float32 and isinstance(ps, float)
        np.testing.assert_allclose(pm, jm, atol=ATOL, rtol=0)
        assert abs(ps - js) <= ATOL


def test_mixed_class_batching_equals_sequential(engines):
    eng = engines[1]
    imgs = _images(7, 4)
    classes = ["bottle", "cable", "bottle", "cable"]
    ref = [eng.submit(im, "MVTec", c) for im, c in zip(imgs, classes)]
    results = [None] * 4
    batches = eng.stats()["batches"]

    def worker(i):
        results[i] = eng.submit(imgs[i], "MVTec", classes[i])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert eng.stats()["batches"] - batches < 4  # some requests shared one
    for (m_ref, s_ref), got in zip(ref, results):
        np.testing.assert_allclose(got[0], m_ref, atol=1e-5, rtol=0)
        assert abs(got[1] - s_ref) <= 1e-6


def test_map_stride_slices_the_same_batch_exactly(engines):
    eng = engines[1]
    blocker, img = _images(9, 2)
    results = {}

    def go(stride, image=img):
        results[stride] = eng.submit(image, "MVTec", "bottle",
                                     map_stride=stride)

    # a slow forward holds a first request while the three strides queue
    # behind it, so the three share the next batch
    orig = eng._predict

    def slow(*a):
        time.sleep(0.3)
        return orig(*a)

    eng._predict = slow
    batches = eng.stats()["batches"]
    try:
        first = threading.Thread(target=go, args=(2, blocker))
        first.start()
        time.sleep(0.1)
        ts = [threading.Thread(target=go, args=(s,)) for s in (1, 5, 7)]
        for t in ts:
            t.start()
        for t in [first] + ts:
            t.join(timeout=30)
    finally:
        eng._predict = orig
    assert eng.stats()["batches"] - batches == 2
    base = results[1][0]
    np.testing.assert_array_equal(results[5][0], base[::5, ::5])
    np.testing.assert_array_equal(results[7][0], base[::7, ::7])
    assert results[1][1] == results[5][1] == results[7][1]


def test_bucket_sizing_matches_jax(engines):
    port_eng = engines[1]
    for max_batch in (1, 3, 4, 6, 8, 16):
        fake = types.SimpleNamespace(max_batch=max_batch, _dp_devices=1,
                                     _shard_batches=False)
        port = types.SimpleNamespace(max_batch=max_batch)
        got = [psrv.InferenceEngine._bucket(port, n)
               for n in range(1, max_batch + 1)]
        assert got == [jsrv.InferenceEngine._bucket(fake, n)
                       for n in range(1, max_batch + 1)]
    assert [port_eng._bucket(n) for n in (1, 2, 3, 4)] == [1, 2, 4, 4]


@pytest.mark.parametrize("case", ["unknown_class", "unknown_dataset",
                                  "wrong_size", "wrong_dtype", "stride_0"])
def test_bad_submits_raise_as_jax(engines, case):
    img = _images(2, 1)[0]
    args = {"unknown_class": (img, "MVTec", "spaceship"),
            "unknown_dataset": (img, "VisA", "candle"),
            "wrong_size": (img[:, :48, :48], "MVTec", "bottle"),
            "wrong_dtype": (img.astype(np.float32), "MVTec", "bottle"),
            "stride_0": (img, "MVTec", "bottle")}[case]
    kw = {"map_stride": 0} if case == "stride_0" else {}
    errors = []
    for eng in engines:
        with pytest.raises((KeyError, ValueError)) as e:
            eng.submit(*args, **kw)
        errors.append((type(e.value), str(e.value)))
    assert errors[0] == errors[1]


def test_open_loop_overload_sheds_fast(assets):
    """A burst far above capacity: admission control bounds the backlog at
    max_queue and fails the excess at once with EngineOverloadedError,
    while every admitted request completes (JAX's own test, on the
    port)."""
    kw = _engine_kwargs(*assets, max_batch=2)
    engine = psrv.InferenceEngine(**kw, max_queue=4, device="cpu")
    try:
        orig = engine._predict

        def slow_predict(*a):
            time.sleep(0.25)
            return orig(*a)

        engine._predict = slow_predict
        n = 30
        outcomes = [None] * n
        imgs = _images(13, n)

        def fire(i):
            t0 = time.perf_counter()
            try:
                engine.submit(imgs[i], "MVTec", "bottle", timeout=60)
                outcomes[i] = ("ok", time.perf_counter() - t0)
            except psrv.EngineOverloadedError:
                outcomes[i] = ("rejected", time.perf_counter() - t0)
            except Exception as e:
                outcomes[i] = ("err", str(e))

        threads = [threading.Thread(target=fire, args=(i,)) for i in range(n)]
        # frequent thread switches: a lost update of the shared counters
        # would break the counts below
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=90)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads)
        kinds = [o[0] for o in outcomes]
        assert "err" not in kinds and None not in outcomes
        rejects = [o for o in outcomes if o[0] == "rejected"]
        assert rejects and max(o[1] for o in rejects) < 2.0
        assert "ok" in kinds
        s = engine.stats()
        assert s["requests"] == n and s["rejected"] == len(rejects)
        assert s["max_queue"] == 4 and s["latency_ms"]["p95"] is not None
    finally:
        engine.shutdown()


def test_phase_probe_splits_the_upload(assets, monkeypatch):
    monkeypatch.setenv("AACLIP_SERVE_PHASE_PROBE", "1")
    engine = psrv.InferenceEngine(**_engine_kwargs(*assets, max_batch=2),
                                  device="cpu")
    try:
        engine.submit(_images(3, 1)[0], "MVTec", "bottle")
        s = engine.stats()
        assert s["phases"]["h2d_probe"]["n"] >= 1
        assert s["phases"]["device_wait"]["n"] >= 1
    finally:
        engine.shutdown()


# -- adapter discovery and the anchor cache ------------------------------------


def _trees(seed):
    cfg, acfg = get_config("tiny-test"), AdapterConfig(**ACFG)
    return (adapter_to_jax(init_image_adapter(cfg, acfg, seed=seed,
                                              device="cpu")),
            text_adapter_to_jax(init_text_adapter(cfg, acfg, seed=seed,
                                                  device="cpu")))


@pytest.mark.parametrize("layout", ["epochs", "rolling", "tmp_leftover",
                                    "text_only", "empty"])
def test_adapter_discovery_matches_jax(tmp_path, layout):
    from aaclip_tpu.train.checkpoint import discover_serving_adapters

    (img2, _), (img10, text), (rolling, _) = _trees(7), _trees(8), _trees(9)

    def save(name, tree, epoch=1):
        ckpt.save_adapter_checkpoint(str(tmp_path / name), epoch, tree)

    if layout == "epochs":  # parsed epochs: 10 after 2, then the rolling
        save("image_adapter_2.npz", img2, 2)
        save("image_adapter_10.npz", img10, 10)
        save("image_adapter.npz", rolling, 10)
        save("text_adapter.npz", text, 0)
    elif layout == "rolling":
        save("image_adapter.npz", rolling, 5)
    elif layout == "tmp_leftover":
        save("image_adapter.npz", rolling, 7)
        (tmp_path / "image_adapter_1.npz.tmp-999.npz").write_bytes(b"trunc")
    elif layout == "text_only":
        save("text_adapter.npz", text, 0)
    templates = _trees(0)
    got = ckpt.discover_serving_adapters(str(tmp_path), *templates)
    want = discover_serving_adapters(str(tmp_path), *templates)
    assert got[2:] == want[2:]
    for g, w in zip(got[:2], want[:2]):
        for a, b in zip(ckpt._flatten(g).values(), ckpt._flatten(w).values()):
            np.testing.assert_array_equal(a, np.asarray(b))
    expect_image = {"epochs": img10, "rolling": rolling,
                    "tmp_leftover": rolling}.get(layout, templates[0])
    for a, b in zip(ckpt._flatten(got[0]).values(),
                    ckpt._flatten(expect_image).values()):
        np.testing.assert_array_equal(a, b)


def test_engine_serves_the_latest_snapshot_and_flags_untrained(assets,
                                                              tmp_path,
                                                              caplog):
    ckpt_path, _ = assets
    (old, _), (new, _) = _trees(7), _trees(8)
    ckpt.save_adapter_checkpoint(str(tmp_path / "image_adapter_2.npz"), 2,
                                 old)
    ckpt.save_adapter_checkpoint(str(tmp_path / "image_adapter_10.npz"), 10,
                                 new)
    with caplog.at_level("WARNING", logger="aaclip.serve"):
        eng = psrv.InferenceEngine(
            **_engine_kwargs(ckpt_path, str(tmp_path), max_batch=1),
            precompile=False, device="cpu")
    eng.shutdown()
    assert not eng.untrained
    assert any("FROZEN text encoder" in r.message for r in caplog.records)
    got = adapter_to_jax(eng.image_adapter)
    for a, b in zip(ckpt._flatten(got).values(),
                    ckpt._flatten(new).values()):
        np.testing.assert_array_equal(a, b)
    fresh = psrv.InferenceEngine(**_engine_kwargs(ckpt_path, None,
                                                  max_batch=1),
                                 precompile=False, device="cpu")
    fresh.shutdown()
    assert fresh.untrained


def test_engine_anchor_cache(assets, tmp_path, monkeypatch, engines):
    """Cached anchors equal the uncached engine's bit for bit; a second
    engine on the same cache reads it and runs no text forward."""
    from aaclip_tpu_torch.text import anchors as anchors_mod

    kw = dict(_engine_kwargs(*assets, max_batch=1), precompile=False,
              anchor_cache=str(tmp_path), device="cpu")
    first = psrv.InferenceEngine(**kw)
    first.shutdown()
    assert len(list(tmp_path.glob("anchors_*.npz"))) == 1
    calls = []
    real = anchors_mod.encode_dataset_anchors

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(anchors_mod, "encode_dataset_anchors", counting)
    second = psrv.InferenceEngine(**kw)
    second.shutdown()
    assert calls == []
    uncached = engines[1].anchors["MVTec"]
    for cls, want in uncached.items():
        np.testing.assert_array_equal(first.anchors["MVTec"][cls], want)
        np.testing.assert_array_equal(second.anchors["MVTec"][cls], want)
    assert len(list(tmp_path.glob("anchors_*.npz"))) == 1


@pytest.mark.parametrize("kw", [{"data_parallel": True},
                                {"artifact": "somewhere"},
                                {"precision": "int8"}])
def test_unported_engine_options_raise_naming_a12(assets, kw):
    args = dict(_engine_kwargs(*assets), device="cpu")
    args.update(kw)
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        psrv.InferenceEngine(**args)


@pytest.mark.parametrize("flags", [["--data_parallel"],
                                   ["--artifact", "somewhere"],
                                   ["--precision", "int8"]])
def test_unported_cli_flags_raise_naming_a12(flags):
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        psrv.parse_args(flags)


def test_cli_flags_and_defaults_match_jax(capsys):
    import argparse

    with pytest.raises(SystemExit):
        psrv.parse_args(["--help"])
    out = capsys.readouterr().out
    for flag in ("--anchor_cache", "--no_precompile", "--max_queue",
                 "--save_path", "--levels"):
        assert flag in out
    port = vars(psrv.parse_args([]))
    seen = {}
    real = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        seen.update(vars(real(self, args, namespace)))
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = capture
    try:
        with pytest.raises(SystemExit):
            jsrv.main([])
    finally:
        argparse.ArgumentParser.parse_args = real
    assert sorted(port) == sorted(seen)
    for k, v in seen.items():
        if k != "anchor_cache":  # each package keeps its own directory
            assert port[k] == v, k


# -- HTTP ---------------------------------------------------------------------


def _predict_url(base, cls="bottle", **query):
    q = "&".join(f"{k}={v}" for k, v in query.items())
    return f"{base}/predict?dataset=MVTec&class_name={cls}" + (
        f"&{q}" if q else "")


@pytest.mark.parametrize("stride", [1, 7])
def test_http_predict_json_matches_jax(servers, stride):
    body = _png(1)
    out = [_request(_predict_url(u, "cable", map_stride=stride), body)
           for u in servers]
    (jc, _, jb), (pc, _, pb) = out
    assert jc == pc == 200
    j, p = json.loads(jb), json.loads(pb)
    assert sorted(p) == sorted(j) == ["anomaly_map", "image_score",
                                      "map_shape"]  # trained: no flag
    assert p["map_shape"] == j["map_shape"] == [-(-70 // stride)] * 2
    np.testing.assert_allclose(np.asarray(p["anomaly_map"]),
                               np.asarray(j["anomaly_map"]),
                               atol=ATOL + 1e-4, rtol=0)
    assert abs(p["image_score"] - j["image_score"]) <= ATOL


@pytest.mark.parametrize("encoding", ["f16", "u8"])
def test_http_binary_encodings_match_jax(servers, encoding):
    body = _png(2)
    out = [_request(_predict_url(u, map_stride=3, map_encoding=encoding),
                    body) for u in servers]
    (jc, jh, jb), (pc, ph, pb) = out
    assert jc == pc == 200
    xj = sorted(k for k in jh if k.startswith("X-"))
    xp = sorted(k for k in ph if k.startswith("X-"))
    assert xp == xj
    assert ph["Content-Type"] == jh["Content-Type"] == \
        "application/octet-stream"
    assert ph["X-Map-Shape"] == jh["X-Map-Shape"] == "24,24"
    assert abs(float(ph["X-Image-Score"]) - float(jh["X-Image-Score"])) \
        <= ATOL

    def decode(h, b):
        if encoding == "f16":
            return np.frombuffer(b, "<f2").reshape(24, 24).astype(np.float32)
        return float(h["X-Map-Offset"]) + float(h["X-Map-Scale"]) * \
            np.frombuffer(b, np.uint8).reshape(24, 24).astype(np.float32)

    j, p = decode(jh, jb), decode(ph, pb)
    if encoding == "f16":
        bar = ATOL + float(np.spacing(np.float16(np.abs(j).max())))
    else:
        bar = ATOL + (float(jh["X-Map-Scale"])
                      + float(ph["X-Map-Scale"])) / 2 + 1e-6
    np.testing.assert_allclose(p, j, atol=bar, rtol=0)


def test_http_healthz_classes_statz_carry_jax_keys(servers):
    (jurl, purl) = servers
    _request(_predict_url(purl), _png(3))
    _request(_predict_url(jurl), _png(3))
    for path in ("/healthz", "/classes?dataset=MVTec", "/statz"):
        (jc, _, jb), (pc, _, pb) = [_request(u + path) for u in servers]
        assert jc == pc == 200
        j, p = json.loads(jb), json.loads(pb)
        assert sorted(p) == sorted(j), path
        if path != "/statz":
            assert p == j, path
    s = json.loads(_request(purl + "/statz")[2])
    assert sorted(s["latency_ms"]) == ["max", "p50", "p95"]
    for phase in ("http_read", "decode", "queue_wait", "stack_pad",
                  "dispatch", "device_wait", "map_fetch", "respond"):
        row = s["phases"][phase]
        assert sorted(row) == ["mean_ms", "n", "p50_ms", "p95_ms",
                               "total_s"]
        assert row["n"] >= 1 and row["p95_ms"] >= row["p50_ms"] >= 0


@pytest.mark.parametrize("case", [
    "no_class", "garbage", "unknown_class", "bad_stride", "bad_encoding",
    "empty_body", "unknown_post", "unknown_get", "unknown_dataset"])
def test_http_error_paths_match_jax(servers, case):
    png = _png(4)
    reqs = {
        "no_class": (lambda u: u + "/predict?dataset=MVTec", png),
        "garbage": (lambda u: _predict_url(u), b"not an image"),
        "unknown_class": (lambda u: _predict_url(u, "spaceship"), png),
        "bad_stride": (lambda u: _predict_url(u, map_stride="abc"), png),
        "bad_encoding": (lambda u: _predict_url(u, map_encoding="gzip"),
                         png),
        "empty_body": (lambda u: _predict_url(u), b""),
        "unknown_post": (lambda u: u + "/nowhere", png),
        "unknown_get": (lambda u: u + "/nowhere", None),
        "unknown_dataset": (lambda u: u + "/classes?dataset=VisA", None),
    }
    make, data = reqs[case]
    (jc, _, jb), (pc, _, pb) = [_request(make(u), data) for u in servers]
    assert pc == jc and pc in (400, 404)
    assert sorted(json.loads(pb)) == sorted(json.loads(jb)) == ["error"]


def test_http_429_when_overloaded(servers, engines):
    codes = []
    for eng, url in zip(engines, servers):
        orig = eng.submit
        err = (jsrv if eng is engines[0] else psrv).EngineOverloadedError

        def overloaded(*a, _err=err, **k):
            raise _err("request queue full (test)")

        eng.submit = overloaded
        try:
            code, headers, body = _request(_predict_url(url), _png(9))
        finally:
            eng.submit = orig
        codes.append((code, headers.get("Retry-After"),
                      "queue full" in json.loads(body)["error"]))
    assert codes[0] == codes[1] == (429, "1", True)


def test_http_413_on_oversized_body(servers, monkeypatch):
    monkeypatch.setattr(jsrv, "MAX_BODY_BYTES", 1_000_000)
    monkeypatch.setattr(psrv, "MAX_BODY_BYTES", 1_000_000)
    body = b"x" * 3_000_000
    out = [_request(_predict_url(u), body) for u in servers]
    assert [c for c, _, _ in out] == [413, 413]
    assert all("exceeds" in json.loads(b)["error"] for _, _, b in out)


def test_decode_matches_the_evaluation_path(tmp_path):
    """A request body decodes as the evaluation path decodes the same file
    (the host library or numpy), bit for bit, gray and RGB, and as the
    JAX server decodes it (PIL)."""
    from aaclip_tpu_torch.data.transforms import load_rgb_chw

    rng = np.random.default_rng(5)
    for shape in ((40, 57, 3), (33, 33)):
        png = encode_png((rng.random(shape) * 255).astype(np.uint8))
        path = tmp_path / "x.png"
        path.write_bytes(png)
        got = psrv._decode_image(png, 70)
        np.testing.assert_array_equal(got, load_rgb_chw(str(path), 70,
                                                        uint8=True))
        np.testing.assert_array_equal(got, jsrv._decode_image(png, 70))


def test_bench_serve_prints_its_json_line(capsys):
    from aaclip_tpu_torch import bench

    bench.main(["--mode", "serve", "--model_name", "tiny-test",
                "--img_size", "70", "--precision", "fp32", "--steps", "1",
                "--clients", "2"], device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "serve_maps_per_sec_per_chip"
    assert line["value"] > 0 and line["errors"] == 0 and line["served"] > 0
    assert "2 closed-loop clients" in line["unit"]
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        bench.main(["--mode", "serve", "--artifact", "somewhere"],
                   device="cpu")
