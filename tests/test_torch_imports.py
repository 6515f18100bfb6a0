"""The port stands alone: client_tpu_torch and chip_smoke.py import neither
JAX nor the JAX package, and the port's entry points run on the card unless
the CPU is asked for."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
sys.path.insert(0, {repo!r})
import client_tpu_torch
names = ["client_tpu_torch"]
for info in pkgutil.walk_packages(client_tpu_torch.__path__,
                                  "client_tpu_torch."):
    names.append(info.name)
for name in names:
    importlib.import_module(name)
import chip_smoke
banned = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.") or m == "jaxlib"
                or m == "client_tpu" or m.startswith("client_tpu."))
print(json.dumps({{"modules": names, "banned": banned}}))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(repo=REPO)], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    import json
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["banned"] == []
    for expected in ("client_tpu_torch.ops.flash_attention",
                     "client_tpu_torch.ops.paged_attention",
                     "client_tpu_torch.server.scheduler",
                     "client_tpu_torch.server.http_server",
                     "client_tpu_torch.server.__main__",
                     "client_tpu_torch.server.generation",
                     "client_tpu_torch.server.speculation",
                     "client_tpu_torch.server.kv_cache",
                     "client_tpu_torch.server.config",
                     "client_tpu_torch.server.types",
                     "client_tpu_torch.server.stats",
                     "client_tpu_torch.server.core",
                     "client_tpu_torch.perf.bench_harness",
                     "client_tpu_torch.models.transformer",
                     "client_tpu_torch.models.sampling",
                     "client_tpu_torch.models.decoder_lm",
                     "client_tpu_torch.models.resnet",
                     "client_tpu_torch.models.streaming",
                     "client_tpu_torch.models.add_sub",
                     "client_tpu_torch.utils",
                     "client_tpu_torch.utils.shared_memory",
                     "client_tpu_torch.utils.cuda_shared_memory",
                     "client_tpu_torch.server.shm",
                     "client_tpu_torch.perf.perf_utils",
                     "client_tpu_torch.perf.model_parser",
                     "client_tpu_torch.perf.data_loader",
                     "client_tpu_torch.perf.client_backend",
                     "client_tpu_torch.perf.load_manager",
                     "client_tpu_torch.perf.concurrency_manager",
                     "client_tpu_torch.perf.inference_profiler",
                     "client_tpu_torch.bench",
                     "client_tpu_torch.protocol.kserve_pb2",
                     "client_tpu_torch.protocol.grpc_defs",
                     "client_tpu_torch.protocol.grpc_tensors",
                     "client_tpu_torch.server.grpc_server",
                     "client_tpu_torch.server.model",
                     "client_tpu_torch.server.trace",
                     "client_tpu_torch.server.metrics",
                     "client_tpu_torch.server.cache",
                     "client_tpu_torch.server.runtime_stats",
                     "client_tpu_torch.server.faultinject",
                     "client_tpu_torch.server.watchdog",
                     "client_tpu_torch.server.supervision",
                     "client_tpu_torch.server.goodput",
                     "client_tpu_torch.server.timeline",
                     "client_tpu_torch.server.fleet",
                     "client_tpu_torch.server.autoscale",
                     "client_tpu_torch.perf.foreign",
                     "client_tpu_torch.perf.foreign.tfs_pb2",
                     "client_tpu_torch.perf.foreign.tfserve",
                     "client_tpu_torch.perf.foreign.torchserve",
                     "client_tpu_torch.client",
                     "client_tpu_torch.client.http",
                     "client_tpu_torch.client.grpc",
                     "client_tpu_torch.client.retry",
                     "client_tpu_torch.compat",
                     "client_tpu_torch.perf.request_rate_manager",
                     "client_tpu_torch.perf.report",
                     "client_tpu_torch.perf.__main__",
                     "client_tpu_torch.examples.simple_http_cudashm_client",
                     "client_tpu_torch.examples.simple_grpc_cudashm_client",
                     "client_tpu_torch.ops.moe",
                     "client_tpu_torch.ops.ring_attention",
                     "client_tpu_torch.parallel",
                     "client_tpu_torch.parallel.mesh",
                     "client_tpu_torch.parallel.collectives",
                     "client_tpu_torch.parallel.pipeline",
                     "client_tpu_torch.parallel.dryrun",
                     "client_tpu_torch.parallel.spmd"):
        assert expected in result["modules"]


_GRPC_PROBE = r"""
import json, sys
sys.path.insert(0, {repo!r})
import client_tpu_torch, client_tpu_torch.server, client_tpu_torch.models
import client_tpu_torch.server.generation, client_tpu_torch.models.decoder_lm
import client_tpu_torch.server.__main__
import client_tpu_torch.client.http, client_tpu_torch.client.retry
import client_tpu_torch.perf.__main__, client_tpu_torch.perf.report
import client_tpu_torch.perf.request_rate_manager
import client_tpu_torch.examples.simple_http_cudashm_client
from client_tpu_torch.compat import httpclient, cuda_shared_memory, utils
from client_tpu_torch.perf.client_backend import ClientBackendFactory
ClientBackendFactory(client_tpu_torch.perf.client_backend.BackendKind.HTTP,
                     url="localhost:1").create().close()
import client_tpu_torch.perf.foreign
from client_tpu_torch.perf.foreign import TorchServeBackend
ClientBackendFactory(
    client_tpu_torch.perf.client_backend.BackendKind.TORCHSERVE,
    url="localhost:1").create().close()
import client_tpu_torch.server.autoscale
import chip_smoke
print(json.dumps(sorted(m for m in sys.modules
                        if m == "grpc" or m.startswith("grpc.")
                        or m == "google.protobuf"
                        or m.startswith("google.protobuf."))))
"""


def test_the_card_path_imports_neither_grpc_nor_protobuf():
    """The card's host has no grpcio and no protobuf: only the protocol
    and gRPC modules (the gRPC client, its example and the perf
    analyzer's GrpcBackend and TF-Serving backend, on use) import them,
    never the package, the server, the models, the engine, the autoscaler,
    the HTTP client, the compat names, the perf CLI, its HTTP and
    TorchServe backends, the foreign package, the report, the cudashm HTTP
    example or chip_smoke.py."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _GRPC_PROBE.format(repo=REPO)], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    import json
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


_FLEET_PROBE = r"""
import json, sys
sys.path.insert(0, {repo!r})
import client_tpu_torch.server.fleet
import client_tpu_torch.server.autoscale
from client_tpu_torch.models.decoder_lm import (
    make_batch_generator, make_generator, make_replica_fleet)
from client_tpu_torch.models.sampling import sample_loop, sample_step
from client_tpu_torch.models.transformer import decode_loop
print(json.dumps(sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "client_tpu", "grpc")
    or m == "google.protobuf" or m.startswith("google.protobuf."))))
"""


def test_the_fleet_and_the_generators_import_no_jax_grpc_or_protobuf():
    """The fleet router, its autoscaler, the generators and their loops
    import neither JAX, the JAX package, grpc nor protobuf."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _FLEET_PROBE.format(repo=REPO)], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    import json
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


_GRPC_ALLOWED = ("client_tpu_torch.protocol.kserve_pb2",
                 "client_tpu_torch.protocol.grpc_defs",
                 "client_tpu_torch.protocol.grpc_tensors",
                 "client_tpu_torch.server.grpc_server",
                 "client_tpu_torch.client.grpc",
                 "client_tpu_torch.examples.simple_grpc_cudashm_client",
                 "client_tpu_torch.perf.foreign.tfs_pb2",
                 "client_tpu_torch.perf.foreign.tfserve")

_ALLOW_PROBE = r"""
import importlib, json, pkgutil, sys
sys.path.insert(0, {repo!r})
import client_tpu_torch
allowed = {allowed!r}
names = [info.name for info in pkgutil.walk_packages(
    client_tpu_torch.__path__, "client_tpu_torch.")]
for name in names:
    if name not in allowed:
        importlib.import_module(name)
loaded = sorted(m for m in sys.modules
                if m == "grpc" or m.startswith("grpc.")
                or m == "google.protobuf"
                or m.startswith("google.protobuf."))
for name in allowed:
    importlib.import_module(name)
print(json.dumps({{"names": names, "loaded": loaded}}))
"""


def test_only_the_grpc_modules_import_grpc_or_protobuf():
    """Every module of the port but the gRPC ones, imported together,
    loads neither grpc nor protobuf; the allowed ones exist and import."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _ALLOW_PROBE.format(
            repo=REPO, allowed=_GRPC_ALLOWED)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    import json
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["loaded"] == []
    assert set(_GRPC_ALLOWED) <= set(result["names"])


def _entry_points():
    from client_tpu_torch.device import resolve_device
    from client_tpu_torch.models import make_add_sub
    from client_tpu_torch.models import transformer as t
    from client_tpu_torch.models import (
        make_accumulator,
        make_resnet50,
    )
    from client_tpu_torch.models.decoder_lm import (
        decode_config,
        make_batch_generator,
        make_continuous_generator,
        make_decoder_lm,
        make_generator,
        make_replica_fleet,
    )
    from client_tpu_torch.perf.bench_harness import build_bert_encoder
    from client_tpu_torch.server.config import ModelConfig
    from client_tpu_torch.server.generation import ContinuousBatchingEngine
    from client_tpu_torch.server.config import SpeculativeConfig
    from client_tpu_torch.server.model import SequenceModel, TorchModel
    from client_tpu_torch.server.speculation import (
        DraftModel,
        build_draft_model,
    )
    from client_tpu_torch.utils import cuda_shared_memory as cudashm
    from client_tpu_torch.parallel.dryrun import dryrun_multichip
    from client_tpu_torch.parallel.mesh import make_mesh

    cfg = decode_config(vocab_size=16, d_model=8, n_layers=1, n_heads=1,
                        head_dim=8, d_ff=8, max_seq=16)

    def engine(**kw):
        params = t.init_params(torch.Generator().manual_seed(0), cfg)
        return ContinuousBatchingEngine(cfg, params, n_slots=1, chunk=1,
                                        **kw)

    def speculating_engine():
        params = t.init_params(torch.Generator().manual_seed(0), cfg)
        return engine(speculative_draft=DraftModel(cfg, params),
                      speculative_gamma=2)

    return {
        "resolve_device": lambda: resolve_device(),
        "resolve_device_cuda": lambda: resolve_device("cuda"),
        "TorchModel": lambda: TorchModel(ModelConfig(name="m"),
                                         lambda p, x: x),
        "make_add_sub": lambda: make_add_sub(),
        "build_bert_encoder": lambda: build_bert_encoder(8, 2),
        "ContinuousBatchingEngine": engine,
        "speculating_engine": speculating_engine,
        "build_draft_model": lambda: build_draft_model(
            cfg, SpeculativeConfig(enabled=True, gamma=2)),
        "make_continuous_generator": lambda: make_continuous_generator(),
        "cuda_shm_region": lambda: cudashm.create_shared_memory_region(
            "r", 8),
        "SequenceModel": lambda: SequenceModel(
            ModelConfig(name="s"), lambda p, x, s: (x, s), lambda: None),
        "make_accumulator": lambda: make_accumulator(),
        "make_decoder_lm": lambda: make_decoder_lm(cfg=cfg),
        "make_resnet50": lambda: make_resnet50(),
        "make_generator": lambda: make_generator(cfg=cfg),
        "make_batch_generator": lambda: make_batch_generator(cfg=cfg),
        "make_replica_fleet": lambda: make_replica_fleet(cfg=cfg),
        "make_mesh": lambda: make_mesh(),
        "dryrun_multichip": lambda: dryrun_multichip(1),
    }


@pytest.mark.parametrize("entry", ["resolve_device", "resolve_device_cuda",
                                   "TorchModel", "make_add_sub",
                                   "build_bert_encoder",
                                   "ContinuousBatchingEngine",
                                   "speculating_engine",
                                   "build_draft_model",
                                   "make_continuous_generator",
                                   "cuda_shm_region", "SequenceModel",
                                   "make_accumulator", "make_decoder_lm",
                                   "make_resnet50", "make_generator",
                                   "make_batch_generator",
                                   "make_replica_fleet", "make_mesh",
                                   "dryrun_multichip"])
def test_entry_points_without_a_device_raise_when_cuda_is_absent(
        entry, monkeypatch):
    # the same code path a machine without CUDA takes, on any machine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entry_points()[entry]()


def test_cpu_is_used_only_when_asked_for():
    from client_tpu_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_chip_smoke_exits_nonzero_without_cuda(monkeypatch):
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as ei:
        chip_smoke.main()
    assert ei.value.code != 0


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    """A directory that holds chip_smoke.py and nothing else of the repo."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_bytes(open(os.path.join(REPO, "chip_smoke.py"), "rb").read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
