"""The perf analyzer's foreign backends (``client_tpu_torch/perf/foreign``)
against the JAX package's, over the reference's own mock services.

The mock TF-Serving service (gRPC, skipped without grpcio) and the mock
TorchServe service (stdlib HTTP) are the fixtures of
``tests/test_foreign_backends.py``. Each case drives both packages'
backends, model parsers and perf CLIs against the same service and holds
the port to the reference's outputs, parser state and exit codes; the
port's copy of each of that file's tests is here as well. The TF-Serving
result decoder is held field for field on the same response bytes, and
``tfs_pb2`` is checked to build its messages in a pool of its own, wire
compatible with the reference's.
"""

import json
import threading

import numpy as np
import pytest

from client_tpu.perf import __main__ as jmain
from client_tpu.perf import client_backend as jcb
from client_tpu.perf import model_parser as jmp
from client_tpu.perf.foreign import tfs_pb2 as jpb
from client_tpu_torch.perf import __main__ as tmain
from client_tpu_torch.perf import client_backend as tcb
from client_tpu_torch.perf import model_parser as tmp
from client_tpu_torch.perf.foreign import tfs_pb2 as tpb
from test_foreign_backends import tfs_server, torchserve_server  # noqa: F401

PKGS = {"ref": (jcb, jmp, jmain), "port": (tcb, tmp, tmain)}


def _backend(pkg, kind, url, **kw):
    cb = PKGS[pkg][0]
    return cb.ClientBackendFactory(getattr(cb.BackendKind, kind), url=url,
                                   **kw).create()


def _parser_state(p):
    return {"model_name": p.model_name, "model_version": p.model_version,
            "max_batch_size": p.max_batch_size,
            "scheduler_type": p.scheduler_type.value,
            "inputs": {k: (v.datatype, v.dims, v.optional)
                       for k, v in sorted(p.inputs.items())},
            "outputs": {k: (v.datatype, v.dims)
                        for k, v in sorted(p.outputs.items())}}


def _inputs(pkg, arrays):
    ins = []
    for name, arr, dtype in arrays:
        x = PKGS[pkg][0].PerfInput(name, arr.shape, dtype)
        x.set_data_from_numpy(arr)
        ins.append(x)
    return ins


# ------------------------------------------------------------- TF-Serving


def test_tfs_messages_are_private_and_wire_compatible():
    assert tpb.DESCRIPTOR.serialized_pb == jpb.DESCRIPTOR.serialized_pb
    assert tpb.DESCRIPTOR.pool is not jpb.DESCRIPTOR.pool
    for name in jpb.DataType.keys():
        assert getattr(tpb, name) == getattr(jpb, name)
        assert tpb.DataType.Name(getattr(tpb, name)) == name
    req = tpb.PredictRequest()
    req.model_spec.name = "m"
    req.model_spec.version.value = 3
    t = req.inputs["x"]
    t.dtype = tpb.DT_INT32
    t.tensor_shape.dim.add().size = 4
    t.tensor_content = np.arange(4, dtype=np.int32).tobytes()
    back = jpb.PredictRequest.FromString(req.SerializeToString())
    assert back.SerializeToString() == req.SerializeToString()
    assert back.model_spec.version.value == 3


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_tfserve_metadata_and_parser(tfs_server, pkg):  # noqa: F811
    backend = _backend(pkg, "TFSERVE", tfs_server)
    parser = PKGS[pkg][1].ModelParser()
    parser.init_tfserve(backend, "add_sub_tfs")
    assert set(parser.inputs) == {"INPUT0", "INPUT1"}
    assert parser.inputs["INPUT0"].datatype == "INT32"
    assert parser.inputs["INPUT0"].dims == [16]
    assert set(parser.outputs) == {"OUTPUT0", "OUTPUT1"}
    backend.close()


@pytest.mark.parametrize("batch,signature", [
    (1, "serving_default"), (4, "serving_default"), (1, "missing")])
def test_tfserve_metadata_and_parser_match_the_reference(
        tfs_server, batch, signature):  # noqa: F811
    got = {}
    for pkg in PKGS:
        backend = _backend(pkg, "TFSERVE", tfs_server,
                           signature_name=signature)
        parser = PKGS[pkg][1].ModelParser()
        try:
            meta = backend.model_metadata("add_sub_tfs")
            try:
                parser.init_tfserve(backend, "add_sub_tfs", "", signature,
                                    batch)
                got[pkg] = (meta, _parser_state(parser),
                            backend.server_extensions(),
                            backend.model_config("add_sub_tfs"))
            except ValueError as e:
                got[pkg] = (meta, "ValueError", str(e))
        finally:
            backend.close()
    assert got["port"] == got["ref"]
    if signature == "missing":
        assert got["port"][1] == "ValueError"
    elif batch > 1:
        assert got["port"][1]["max_batch_size"] == 4
        assert got["port"][1]["inputs"]["INPUT0"] == ("INT32", [], False)


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_tfserve_infer_sync_and_async(tfs_server, pkg):  # noqa: F811
    backend = _backend(pkg, "TFSERVE", tfs_server)
    a = np.arange(16, dtype=np.int32)
    b = np.ones(16, dtype=np.int32)
    ins = _inputs(pkg, [("INPUT0", a, "INT32"), ("INPUT1", b, "INT32")])
    res = backend.infer("add_sub_tfs", ins)
    np.testing.assert_array_equal(res.as_numpy("OUTPUT0"), a + b)
    np.testing.assert_array_equal(res.as_numpy("OUTPUT1"), a - b)

    done = threading.Event()
    got = {}

    def cb(result, error):
        got["result"], got["error"] = result, error
        done.set()

    backend.async_infer(cb, "add_sub_tfs", ins)
    assert done.wait(10)
    assert got["error"] is None
    np.testing.assert_array_equal(got["result"].as_numpy("OUTPUT0"), a + b)
    stat = backend.client_infer_stat()
    assert stat.completed_request_count == 2
    backend.close()


def test_tfserve_infer_matches_the_reference(tfs_server):  # noqa: F811
    rng = np.random.default_rng(0)
    a = rng.integers(-100, 100, 16).astype(np.int32)
    b = rng.integers(-100, 100, 16).astype(np.int32)
    got = {}
    for pkg in PKGS:
        backend = _backend(pkg, "TFSERVE", tfs_server)
        try:
            ins = _inputs(pkg, [("INPUT0", a, "INT32"),
                                ("INPUT1", b, "INT32")])
            res = backend.infer("add_sub_tfs", ins, model_version="2")
            got[pkg] = (res.get_response().SerializeToString(),
                        {n: res.as_numpy(n).tolist()
                         for n in ("OUTPUT0", "OUTPUT1")},
                        res.as_numpy("NOPE"),
                        backend.client_infer_stat().completed_request_count)
        finally:
            backend.close()
    assert got["port"] == got["ref"]
    assert got["port"][1]["OUTPUT0"] == (a + b).tolist()


def _response(pb, field, dtype, values, shape):
    resp = pb.PredictResponse()
    t = resp.outputs["y"]
    t.dtype = getattr(pb, dtype)
    for d in shape:
        t.tensor_shape.dim.add().size = d
    if field == "tensor_content":
        t.tensor_content = values.tobytes()
    else:
        getattr(t, field).extend(values)
    return resp.SerializeToString()


@pytest.mark.parametrize("field,dtype,values", [
    ("tensor_content", "DT_FLOAT", np.arange(6, dtype=np.float32) / 3),
    ("float_val", "DT_FLOAT", [0.5, 1.5, -2.0, 3.25, 4.0, 5.0]),
    ("double_val", "DT_DOUBLE", [0.1, 0.2, 0.3, 0.4, 0.5, 0.6]),
    ("int_val", "DT_INT32", [1, -2, 3, -4, 5, -6]),
    ("int_val", "DT_INT8", [1, -2, 3, -4, 5, -6]),
    ("int64_val", "DT_INT64", [1, 2 ** 40, 3, 4, 5, 6]),
    ("bool_val", "DT_BOOL", [True, False, True, True, False, False]),
    ("uint32_val", "DT_UINT32", [1, 2, 3, 4, 5, 2 ** 31]),
    ("uint64_val", "DT_UINT64", [1, 2, 3, 4, 5, 2 ** 40]),
    ("half_val", "DT_HALF",
     np.array([0.5, 1, 2, -1, 3, 7], np.float16).view(np.uint16).tolist()),
    ("string_val", "DT_STRING", [b"a", b"bc", b"", b"d", b"e", b"f"]),
])
def test_tfs_result_decodes_like_the_reference(field, dtype, values):
    from client_tpu.perf.foreign.tfserve import TfsResult as JResult
    from client_tpu_torch.perf.foreign.tfserve import TfsResult as TResult

    wire = _response(tpb, field, dtype, values, (2, 3))
    want = JResult(jpb.PredictResponse.FromString(wire)).as_numpy("y")
    got = TResult(tpb.PredictResponse.FromString(wire)).as_numpy("y")
    assert got.dtype == want.dtype and got.shape == want.shape == (2, 3)
    assert got.tolist() == want.tolist()


def test_tfs_result_without_values_fails_like_the_reference():
    from client_tpu.perf.foreign.tfserve import TfsResult as JResult
    from client_tpu_torch.perf.foreign.tfserve import TfsResult as TResult

    errs = []
    for pb, cls in ((jpb, JResult), (tpb, TResult)):
        wire = _response(pb, "float_val", "DT_FLOAT", [], (2,))
        with pytest.raises(ValueError) as ei:
            cls(pb.PredictResponse.FromString(wire)).as_numpy("y")
        errs.append(str(ei.value))
        empty = _response(pb, "float_val", "DT_FLOAT", [], (0, 3))
        assert cls(pb.PredictResponse.FromString(empty)).as_numpy(
            "y").shape == (0, 3)
    assert errs[0] == errs[1]


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_tfserve_profile_end_to_end(tfs_server, capsys, pkg):  # noqa: F811
    rc = PKGS[pkg][2].main(
        ["-m", "add_sub_tfs", "--service-kind", "tfserve",
         "-u", tfs_server, "--sync", "-p", "200", "-s", "90",
         "-r", "3", "--concurrency-range", "2"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Throughput" in out


@pytest.mark.parametrize("extra", [
    ["--shared-memory", "system"], ["--streaming", "-i", "grpc"],
    ["-H", "x-a:b"], ["--model-signature-name", "missing"]])
def test_tfserve_cli_refusals_match_the_reference(tfs_server, capsys,
                                                  extra):  # noqa: F811
    codes = {}
    for pkg in PKGS:
        argv = ["-m", "add_sub_tfs", "--service-kind", "tfserve",
                "-u", tfs_server, "-p", "200", "-r", "2"] + extra
        try:
            codes[pkg] = PKGS[pkg][2].main(argv)
        except ValueError as e:
            codes[pkg] = ("ValueError", str(e))
        capsys.readouterr()
    assert codes["port"] == codes["ref"]
    assert codes["port"] == 2 or codes["port"][0] == "ValueError"


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_tfserve_rejects_shared_memory(tfs_server, capsys,
                                       pkg):  # noqa: F811
    rc = PKGS[pkg][2].main(
        ["-m", "add_sub_tfs", "--service-kind", "tfserve",
         "-u", tfs_server, "--shared-memory", "system"])
    assert rc == 2


# ------------------------------------------------------------- TorchServe


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_torchserve_infer(torchserve_server, tmp_path, pkg):  # noqa: F811
    upload = tmp_path / "payload.bin"
    upload.write_bytes(b"x" * 1024)
    backend = _backend(pkg, "TORCHSERVE", torchserve_server)
    x = PKGS[pkg][0].PerfInput("TORCHSERVE_INPUT", [1], "BYTES")
    x.set_data_from_numpy(np.array([str(upload).encode()], dtype=object))
    res = backend.infer("densenet", [x])
    body = json.loads(res.get_response()["body"])
    assert body["model"] == "densenet"
    assert body["bytes"] > 1024  # payload + multipart framing
    backend.close()


def test_torchserve_infer_and_parser_match_the_reference(
        torchserve_server, tmp_path):  # noqa: F811
    upload = tmp_path / "payload.bin"
    upload.write_bytes(bytes(range(256)) * 9)
    got = {}
    for pkg in PKGS:
        backend = _backend(pkg, "TORCHSERVE", torchserve_server)
        try:
            parser = PKGS[pkg][1].ModelParser()
            parser.init_torchserve("densenet", "1")
            with pytest.raises(ValueError) as ei:
                PKGS[pkg][1].ModelParser().init_torchserve("densenet", "",
                                                           2)
            x = PKGS[pkg][0].PerfInput("TORCHSERVE_INPUT", [1], "BYTES")
            x.set_data_from_numpy(np.array([str(upload)], dtype=object))
            done = threading.Event()
            seen = {}

            def cb(result, error, seen=seen, done=done):
                seen["r"] = (result.get_response(), error)
                done.set()

            res = backend.infer("densenet", [x])
            backend.async_infer(cb, "densenet", [x])
            assert done.wait(10)
            with pytest.raises(ValueError) as empty:
                backend.infer("densenet", [])
            got[pkg] = (_parser_state(parser), str(ei.value),
                        res.get_response(), res.as_numpy("any").tolist(),
                        seen["r"], str(empty.value),
                        backend.model_metadata("densenet"),
                        backend.model_config("densenet"),
                        backend.server_extensions(),
                        backend.client_infer_stat().completed_request_count)
        finally:
            backend.close()
    assert got["port"] == got["ref"]
    assert got["port"][-1] == 2


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_torchserve_profile_end_to_end(torchserve_server, tmp_path, capsys,
                                       pkg):  # noqa: F811
    upload = tmp_path / "img.jpg"
    upload.write_bytes(b"j" * 2048)
    data_json = tmp_path / "data.json"
    data_json.write_text(json.dumps(
        {"data": [{"TORCHSERVE_INPUT": [str(upload)]}]}))
    rc = PKGS[pkg][2].main(
        ["-m", "densenet", "--service-kind", "torchserve",
         "-u", torchserve_server, "--sync",
         "--input-data", str(data_json),
         "-p", "200", "-s", "90", "-r", "3",
         "--concurrency-range", "2"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Throughput" in out


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_torchserve_requires_input_data(torchserve_server,
                                        pkg):  # noqa: F811
    rc = PKGS[pkg][2].main(["-m", "densenet", "--service-kind",
                            "torchserve", "-u", torchserve_server])
    assert rc == 2


@pytest.mark.parametrize("extra", [
    [], ["--input-data", "zero"], ["--shared-memory", "system"],
    ["--streaming", "-i", "grpc"], ["-H", "x-a:b"]])
def test_torchserve_cli_refusals_match_the_reference(torchserve_server,
                                                     capsys,
                                                     extra):  # noqa: F811
    codes, errs = {}, {}
    for pkg in PKGS:
        codes[pkg] = PKGS[pkg][2].main(
            ["-m", "densenet", "--service-kind", "torchserve",
             "-u", torchserve_server] + extra)
        errs[pkg] = capsys.readouterr().err
    assert codes["port"] == codes["ref"] == 2
    assert errs["port"] == errs["ref"]
