"""The port's example clients (``client_tpu_torch/examples/``) against the
port's server and the JAX package's server, on the CPU.

Every script of ``examples/`` has a module of the same name in the port
(the two ``*_tpushm_client.py`` scripts have ``*_cudashm_client`` in
their place). Each case runs the port's example against both servers,
which register the models ``tests/test_examples.py`` registers (the
port's on ``device="cpu"``), and holds it to ``PASS`` against both; then
runs the reference's example against the JAX server and holds the port's
stdout against that same server to the reference's, with ports, times
and addresses masked. The examples run in this process through their
``main(argv)`` (the reference's through ``runpy``), as
``python -m client_tpu_torch.examples.<name>`` would run them.

The generate example also streams from a ``continuous_lm`` on the paged
layout with the plain attention, built in both packages from the same
weights: the port's greedy tokens equal the JAX package's.
"""

import base64
import contextlib
import importlib
import io
import json
import re
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
REF_EXAMPLES = ROOT / "examples"
PORT_EXAMPLES = ROOT / "client_tpu_torch" / "examples"
TPUSHM = {"simple_http_tpushm_client", "simple_grpc_tpushm_client"}
CUDASHM = {"simple_http_cudashm_client", "simple_grpc_cudashm_client"}

TINY = dict(vocab_size=64, d_model=16, n_layers=2, n_heads=2, head_dim=8,
            d_ff=32, max_seq=96, causal=True, attn_impl="ref")
LM_KNOBS = dict(n_slots=2, chunk_size=4, max_new_tokens=16,
                kv_layout="paged")


def _register(core, pkg, cfg, params, device):
    """The models tests/test_examples.py registers, and a paged
    continuous_lm; ``device`` is the port's (None for the reference)."""
    dev = {} if device is None else {"device": device}
    core.register_model(pkg.make_add_sub("add_sub", 16, "INT32", **dev))
    core.register_model(pkg.make_add_sub("add_sub_int8", 16, "INT8", **dev))
    core.register_model(pkg.make_add_sub_string("add_sub_string", 16))
    core.register_model(pkg.make_identity("identity", 16, "INT32", **dev))
    core.register_model(pkg.make_repeat("repeat_int32"))
    core.register_model(pkg.make_generator("generator_lm", **dev))
    core.register_model(pkg.make_accumulator("accumulator", 1, "INT32",
                                             **dev))
    core.register_model(pkg.make_preprocess(max_batch_size=4))
    core.register_model(pkg.make_resnet50(max_batch_size=4,
                                          dynamic_batching=False, **dev))
    core.register_model(pkg.make_image_ensemble(max_batch_size=4))
    core.register_model(pkg.make_continuous_generator(
        "continuous_lm", cfg=cfg, params=params, **LM_KNOBS, **dev))


@pytest.fixture(scope="module")
def servers():
    import client_tpu.models as jmodels
    from client_tpu.models import transformer as jt
    from client_tpu.server import TpuInferenceServer
    from client_tpu.server.grpc_server import GrpcInferenceServer as RefGrpc
    from client_tpu.server.http_server import HttpInferenceServer as RefHttp

    import client_tpu_torch.models as tmodels
    from client_tpu_torch.models import transformer as tt
    from client_tpu_torch.server import TorchInferenceServer
    from client_tpu_torch.server.grpc_server import GrpcInferenceServer
    from client_tpu_torch.server.http_server import HttpInferenceServer

    jcfg = jt.TransformerConfig(dtype=jnp.float32, **TINY)
    jparams = jt.init_params(jax.random.key(3), jcfg)
    tcfg = tt.TransformerConfig(dtype=torch.float32, **TINY)
    tparams = tt.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu",
                                 torch.float32)
    ref, port = TpuInferenceServer(), TorchInferenceServer()
    _register(ref, jmodels, jcfg, jparams, None)
    _register(port, tmodels, tcfg, tparams, "cpu")
    fronts = [RefHttp(ref, port=0).start(), RefGrpc(ref, port=0).start(),
              HttpInferenceServer(port, port=0).start(),
              GrpcInferenceServer(port, port=0).start()]
    try:
        yield {"ref": {"http": f"localhost:{fronts[0].port}",
                       "grpc": fronts[1].address},
               "port": {"http": f"localhost:{fronts[2].port}",
                        "grpc": fronts[3].address}}
    finally:
        for f in fronts:
            f.stop()
        ref.stop()
        port.stop()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from PIL import Image

    tmp = tmp_path_factory.mktemp("example_inputs")
    Image.fromarray(np.zeros((64, 64, 3), np.uint8)).save(
        tmp / "img.jpg", format="JPEG")
    Image.fromarray(np.zeros((48, 48, 3), np.uint8)).save(
        tmp / "img.png", format="PNG")
    buf = io.BytesIO()
    Image.fromarray(np.zeros((32, 32, 3), np.uint8)).save(buf, format="JPEG")
    (tmp / "events.jsonl").write_text(json.dumps(
        {"device_id": "elevator-7",
         "image_b64": base64.b64encode(buf.getvalue()).decode()}) + "\n")
    return tmp


def _http(urls, files):
    return ["-u", urls["http"]]


def _grpc(urls, files):
    return ["-u", urls["grpc"]]


# (case id, script, argv from the side's urls and the input files)
CASES = [
    *((s, s, _http) for s in (
        "simple_http_infer_client", "simple_http_explicit_infer_client",
        "simple_http_async_infer_client", "simple_http_string_infer_client",
        "simple_http_health_metadata", "simple_http_model_control",
        "simple_http_sequence_sync_client", "simple_http_shm_client",
        "simple_http_shm_string_client", "memory_growth_test",
        "ensemble_image_client")),
    ("reuse_infer_objects_client", "reuse_infer_objects_client",
     lambda u, f: ["-u", u["http"], "-g", u["grpc"]]),
    *((s, s, _grpc) for s in (
        "simple_grpc_infer_client", "simple_grpc_async_infer_client",
        "simple_grpc_string_infer_client", "simple_grpc_health_metadata",
        "simple_grpc_keepalive_client", "simple_grpc_model_control",
        "simple_grpc_sequence_sync_client",
        "simple_grpc_sequence_stream_client",
        "simple_grpc_custom_repeat_client", "simple_grpc_shm_client",
        "simple_grpc_shm_string_client", "simple_grpc_generate_client",
        "grpc_client", "grpc_explicit_int_content_client",
        "grpc_explicit_int8_content_client",
        "grpc_explicit_byte_content_client")),
    ("grpc_image_client", "grpc_image_client",
     lambda u, f: ["-u", u["grpc"], str(f / "img.jpg")]),
    ("image_client_http", "image_client",
     lambda u, f: ["-u", u["http"], "-c", "3"]),
    ("image_client_grpc", "image_client",
     lambda u, f: ["-u", u["grpc"], "-i", "grpc"]),
    ("base64_image_client", "base64_image_client",
     lambda u, f: ["-u", u["http"], str(f / "img.png")]),
    ("infer_classification_client", "infer_classification_client",
     lambda u, f: ["-u", u["http"], "-c", "5"]),
    ("device_hub", "device_hub",
     lambda u, f: ["-u", u["http"], "--events", str(f / "events.jsonl")]),
]


def _run_port(script, argv):
    """The port's example through its main(argv): (exit code, stdout)."""
    mod = importlib.import_module(f"client_tpu_torch.examples.{script}")
    out = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(out):
        try:
            mod.main(argv)
        except SystemExit as e:
            code = e.code
    return code, out.getvalue()


def _run_ref(script, argv):
    """The reference's script as ``python examples/<script>.py argv``."""
    out = io.StringIO()
    code = 0
    saved = sys.argv, list(sys.path)
    sys.argv = [str(REF_EXAMPLES / f"{script}.py"), *argv]
    sys.path.insert(0, str(REF_EXAMPLES))    # device_hub's sibling import
    try:
        with contextlib.redirect_stdout(out):
            try:
                runpy.run_path(sys.argv[0], run_name="__main__")
            except SystemExit as e:
                code = e.code
    finally:
        sys.argv, sys.path[:] = saved[0], saved[1]
    return code, out.getvalue()


_MASKS = [
    (re.compile(r"(localhost|127\.0\.0\.1|\[::1?\]|0\.0\.0\.0):\d+"),
     "<addr>"),
    (re.compile(r"\d+(\.\d+)?\s*(ms|us|usec|s|sec|seconds|MiB|KiB|B)\b"),
     "<n><unit>"),
    (re.compile(r"\b(rss|vm|mem\w*)[=:]\s*\S+", re.I), r"\1=<n>"),
]


def _masked(text):
    for rx, sub in _MASKS:
        text = rx.sub(sub, text)
    return text


def _passed(label, code, out):
    assert code in (0, None), f"{label} exited {code}:\n{out}"
    if label.startswith(("device_hub", "examples/device_hub")):
        event = json.loads(out.strip().splitlines()[-1])
        assert event["device_id"] == "elevator-7" and "class" in event
    else:
        assert "PASS" in out, out


@pytest.mark.parametrize("case,script,args", CASES,
                         ids=[c[0] for c in CASES])
def test_port_example_passes_on_both_servers_and_prints_the_reference(
        servers, files, case, script, args):
    outs = {}
    for side in ("port", "ref"):
        code, out = _run_port(script, args(servers[side], files))
        _passed(f"{script} on the {side} server", code, out)
        outs[side] = out
    code, ref_out = _run_ref(script, args(servers["ref"], files))
    _passed(f"examples/{script}.py", code, ref_out)
    assert _masked(outs["ref"]) == _masked(ref_out)


def _tokens(out):
    return [int(m) for m in re.findall(r"token\[\d+\] = (-?\d+)", out)]


def test_generate_example_streams_the_reference_greedy_tokens(servers):
    """simple_grpc_generate_client on continuous_lm (paged, plain
    attention, the same weights): the port's server streams the JAX
    package's greedy tokens, for the port's example and the reference's."""
    for prompt in ("5,11,2", "7,1,30,44,2,9,13,60,3"):
        argv = ["-m", "continuous_lm", "-n", "12", "-p", prompt]
        got = {}
        for side in ("port", "ref"):
            code, out = _run_port("simple_grpc_generate_client",
                                  ["-u", servers[side]["grpc"], *argv])
            _passed(side, code, out)
            got[side] = _tokens(out)
        code, out = _run_ref("simple_grpc_generate_client",
                             ["-u", servers["port"]["grpc"], *argv])
        _passed("examples/simple_grpc_generate_client.py", code, out)
        assert len(got["ref"]) == 12
        assert got["port"] == got["ref"] == _tokens(out), prompt


def test_every_reference_example_has_a_port_module():
    """33 scripts of examples/ (all but the two TPU shared-memory ones)
    have a module of the same name with main(argv=None); no port example
    names the TPU or imports anything of the JAX package."""
    ref = {p.stem for p in REF_EXAMPLES.glob("*.py")}
    port = {p.stem for p in PORT_EXAMPLES.glob("*.py")} - {"__init__"}
    assert len(ref - TPUSHM) == 33
    assert port == (ref - TPUSHM) | CUDASHM
    assert {c[1] for c in CASES} == ref - TPUSHM
    for name in sorted(port):
        # the cudashm pair names the reference script it stands in for
        text = re.sub(r"examples/simple_(http|grpc)_tpushm_client\.py", "",
                      (PORT_EXAMPLES / f"{name}.py").read_text())
        assert "def main(argv=None):" in text, name
        assert not re.search(r"\bTPU|\btpu\b|tpushm|jax", text), name
        assert not re.search(r"\bclient_tpu\b(?!_torch)", text), name
