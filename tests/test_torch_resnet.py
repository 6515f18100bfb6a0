"""The image models in the port (client_tpu_torch.models.resnet), on the
CPU, held against the JAX package's (client_tpu/models/resnet.py).

- ``init_params`` draws the reference's numpy values (bf16 and f32,
  kernels HWIO -> OIHW), bit for bit; ``params_from_jax`` carries the
  reference's tree across to the same tensors.
- ``forward`` with f32 weights at 224x224, batch 2: every logit within
  1e-4 of the largest logit's magnitude of the reference's (measured
  5.2e-7 on the CPU: both accumulate in f32, in different orders).
- ``forward`` in bf16 at 64x64, batch 2 (any HxW): within 2e-2 of the
  largest magnitude (measured 5.5e-3, about one bf16 ulp of it: each
  convolution rounds its f32 sum to bf16 once in both packages, and a sum
  taken in another order rounds to the neighbouring bf16 value now and
  then; the differences grow through 53 convolutions). Both forward
  tests draw random BN scales and biases and FC biases into the
  reference's tree, so the per-channel affine and the bias add count.
- ``preprocess`` of PNG and JPEG bytes (224x224 and other sizes, resized)
  gives bit-equal FP32 images in both packages (the same Pillow).
- Served (``resnet50`` in bf16, ``preprocess`` and the ensemble
  ``preprocess_resnet50``) over HTTP and gRPC with the port's clients:
  the ensemble's logits within the bf16 tolerance of the reference's,
  and bit-equal to ``preprocess`` then ``resnet50`` called one after the
  other on the port; each composing model's statistics count one
  execution per ensemble request, as the reference's do; configs and
  metadata read the same apart from the by-design fields; the
  classification extension's top-3 labels name the same classes wherever
  the logits' gaps exceed the tolerance, and each label's score is its
  logit.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.models import resnet as jr
from client_tpu.server import TpuInferenceServer
from client_tpu.server.http_server import HttpInferenceServer as RefHttp
from client_tpu_torch.client import http as thttp
from client_tpu_torch.models import resnet as tr
from client_tpu_torch.server import TorchInferenceServer
from client_tpu_torch.server.http_server import HttpInferenceServer

PIL = pytest.importorskip("PIL.Image")

SIDES = ("ref", "port")
F32_RTOL = 1e-4
BF16_RTOL = 2e-2


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _as_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_init_params_draw_the_reference_values(dtype):
    jd, td = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
              else (jnp.float32, torch.float32))
    ref = dict(_leaves(jr.init_params(3, 10, jd)))
    port = dict(_leaves(tr.init_params(3, 10, td)))
    assert sorted(ref) == sorted(port)
    for name, w in ref.items():
        p = port[name]
        assert p.dtype == td
        w = _as_f32(w)
        if w.ndim == 4:
            w = w.transpose(3, 2, 0, 1)       # HWIO -> OIHW
        np.testing.assert_array_equal(_as_f32(p), w, err_msg=name)
    carried = dict(_leaves(tr.params_from_jax(jr.init_params(3, 10, jd),
                                               device="cpu")))
    for name, p in port.items():
        assert carried[name].dtype == td
        np.testing.assert_array_equal(_as_f32(carried[name]), _as_f32(p))


def _rel_err(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(a).max())


def _with_random_affine(tree, rng):
    """``tree`` with every BN scale drawn from U[0.5, 1.5], every BN bias
    from N(0, 1) and the FC bias from N(0, 1e3), in the tree's dtype. The
    reference's init leaves them 1 and 0, where a missing or misbroadcast
    affine would not show. Its residual stack has no normalisation, so
    the logits spread over thousands (std about 3e3 at 224x224, 1.3e3 at
    64x64): an FC bias drawn smaller would hide under the tolerances."""
    if isinstance(tree, list):
        return [_with_random_affine(v, rng) for v in tree]
    if not isinstance(tree, dict):
        return tree
    if set(tree) == {"scale", "bias"}:
        c, dt = tree["scale"].shape, tree["scale"].dtype
        return {"scale": jnp.asarray(rng.uniform(0.5, 1.5, c), dt),
                "bias": jnp.asarray(rng.normal(0.0, 1.0, c), dt)}
    out = {k: _with_random_affine(v, rng) for k, v in tree.items()}
    if "w" in tree and "b" in tree:
        out["b"] = jnp.asarray(rng.normal(0.0, 1e3, tree["b"].shape),
                               tree["b"].dtype)
    return out


def test_forward_f32_at_224_matches_the_reference():
    jp = _with_random_affine(jr.init_params(0, 1000, jnp.float32),
                             np.random.default_rng(10))
    tp = tr.params_from_jax(jp, device="cpu")
    x = np.random.default_rng(1).standard_normal((2, 224, 224, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(jr.forward)(jp, x))
    with torch.inference_mode():
        got = tr.forward(tp, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 1000) and got.dtype == np.float32
    assert _rel_err(want, got) <= F32_RTOL


def test_forward_bf16_at_64_matches_the_reference():
    jp = _with_random_affine(jr.init_params(0, 1000),
                             np.random.default_rng(11))
    tp = tr.params_from_jax(jp, device="cpu")
    x = np.random.default_rng(2).standard_normal((2, 64, 64, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(jr.forward)(jp, x))
    with torch.inference_mode():
        got = tr.forward(tp, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 1000) and got.dtype == np.float32
    assert _rel_err(want, got) <= BF16_RTOL


def _encoded(fmt: str, h: int, w: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    img = PIL.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    buf = io.BytesIO()
    img.save(buf, format=fmt)
    return buf.getvalue()


@pytest.mark.parametrize("fmt", ["PNG", "JPEG"])
def test_preprocess_is_bit_equal(fmt):
    raw = np.array([[_encoded(fmt, 224, 224, 1)], [_encoded(fmt, 97, 131, 2)],
                    [_encoded(fmt, 300, 240, 3)]], dtype=np.object_)
    want = jr.make_preprocess().execute({"raw_image": raw})["image"]
    got = tr.make_preprocess().execute({"raw_image": raw})["image"]
    assert got.shape == (3, 224, 224, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------- served models

@pytest.fixture(scope="module")
def servers():
    cores = {"ref": TpuInferenceServer(), "port": TorchInferenceServer()}
    cores["ref"].register_model(jr.make_preprocess())
    cores["ref"].register_model(jr.make_resnet50())
    cores["ref"].register_model(jr.make_image_ensemble())
    cores["port"].register_model(tr.make_preprocess())
    cores["port"].register_model(tr.make_resnet50(device="cpu"))
    cores["port"].register_model(tr.make_image_ensemble())
    http = {"ref": RefHttp(cores["ref"], port=0).start(),
            "port": HttpInferenceServer(cores["port"], port=0).start()}
    grpc_srv = {}
    try:
        import grpc  # noqa: F401

        from client_tpu.server.grpc_server import (
            GrpcInferenceServer as RefGrpc,
        )
        from client_tpu_torch.server.grpc_server import GrpcInferenceServer

        grpc_srv = {"ref": RefGrpc(cores["ref"], port=0).start(),
                    "port": GrpcInferenceServer(cores["port"],
                                                port=0).start()}
    except ImportError:
        pass
    yield {"core": cores, "http": http, "grpc": grpc_srv}
    for side in SIDES:
        http[side].stop()
        if grpc_srv:
            grpc_srv[side].stop()
        cores[side].stop()


def _client(servers, proto, side):
    if proto == "http":
        return thttp, thttp.InferenceServerClient(servers["http"][side].url)
    if not servers["grpc"]:
        pytest.skip("grpcio is not installed")
    from client_tpu_torch.client import grpc as tgrpc

    return tgrpc, tgrpc.InferenceServerClient(
        servers["grpc"][side].address)


def _stats(c, proto, name):
    j = (c.get_inference_statistics(name) if proto == "http"
         else c.get_inference_statistics(name, as_json=True))
    m = j["model_stats"][0]          # gRPC's JSON leaves out zeros
    return (int(m.get("inference_count", 0)),
            int(m.get("execution_count", 0)))


@pytest.mark.parametrize("proto", ["http", "grpc"])
def test_the_image_ensemble_matches_the_reference(servers, proto):
    raw = np.array([[_encoded("PNG", 224, 224, 5)],
                    [_encoded("JPEG", 160, 200, 6)]], dtype=np.object_)
    got = {}
    for side in SIDES:
        mod, c = _client(servers, proto, side)
        try:
            before = [_stats(c, proto, n) for n in
                      ("preprocess_resnet50", "preprocess", "resnet50")]
            r_in = mod.InferInput("raw_image", [2, 1], "BYTES")
            r_in.set_data_from_numpy(raw)
            logits = c.infer("preprocess_resnet50", [r_in]).as_numpy(
                "logits")
            after = [_stats(c, proto, n) for n in
                     ("preprocess_resnet50", "preprocess", "resnet50")]
            image = c.infer("preprocess", [r_in]).as_numpy("image")
            i_in = mod.InferInput("image", list(image.shape), "FP32")
            i_in.set_data_from_numpy(image)
            direct = c.infer("resnet50", [i_in]).as_numpy("logits")
            got[side] = (logits, image, direct,
                         [(a[0] - b[0], a[1] - b[1])
                          for a, b in zip(after, before)])
        finally:
            c.close()
    logits, image, direct, deltas = got["port"]
    assert logits.shape == (2, 1000) and logits.dtype == np.float32
    np.testing.assert_array_equal(logits, direct)
    np.testing.assert_array_equal(image, got["ref"][1])
    assert _rel_err(got["ref"][0], logits) <= BF16_RTOL
    assert deltas == got["ref"][3] == [(2, 1), (2, 1), (2, 1)]


@pytest.mark.parametrize("model", ["preprocess", "resnet50",
                                   "preprocess_resnet50"])
def test_image_configs_and_metadata_read_the_same(servers, model):
    cfg, meta = {}, {}
    for side in SIDES:
        _, c = _client(servers, "http", side)
        try:
            cfg[side] = c.get_model_config(model)
            meta[side] = c.get_model_metadata(model)
        finally:
            c.close()
        cfg[side]["instance_group"][0].pop("kind")
        cfg[side].pop("backend")
        if model != "preprocess_resnet50":
            cfg[side].pop("platform")
            meta[side].pop("platform")
    assert cfg["port"] == cfg["ref"]
    assert meta["port"] == meta["ref"]


def test_classification_on_resnet50(servers):
    x = np.random.default_rng(8).uniform(-1, 1, (2, 224, 224, 3)).astype(
        np.float32)
    got = {}
    for side in SIDES:
        _, c = _client(servers, "http", side)
        try:
            i_in = thttp.InferInput("image", [2, 224, 224, 3], "FP32")
            i_in.set_data_from_numpy(x)
            out = thttp.InferRequestedOutput("logits", class_count=3)
            labels = c.infer("resnet50", [i_in], outputs=[out]).as_numpy(
                "logits")
            logits = c.infer("resnet50", [i_in]).as_numpy("logits")
        finally:
            c.close()
        got[side] = (labels, logits)
    for side in SIDES:
        labels, logits = got[side]
        assert labels.shape == (2, 3) and labels.dtype == np.object_
        for row in range(2):
            for lab in labels[row]:
                score, idx = lab.decode().split(":")
                assert float(score) == pytest.approx(
                    float(logits[row, int(idx)]), abs=1e-5 * max(
                        1.0, abs(float(score))))
    tol = BF16_RTOL * np.abs(got["ref"][1]).max()
    for row in range(2):
        ref_logits = got["ref"][1][row]
        order = np.argsort(-ref_logits)
        for k in range(3):
            gaps = [abs(ref_logits[order[k]] - ref_logits[order[j]])
                    for j in range(4) if j != k]
            if min(gaps) <= 2 * tol:
                continue   # a near tie: either package may rank it first
            port_idx = int(got["port"][0][row][k].decode().split(":")[1])
            assert port_idx == int(order[k])
