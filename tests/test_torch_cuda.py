"""The port's CUDA kernels on the card, held against their plain versions.

Every test here needs an NVIDIA Hopper card and ``nvcc`` (the kernels
are built from ``client_tpu_torch/ops/csrc`` at first use) and skips
without CUDA: a CUDA kernel has no CPU mode, and on the CPU the wrappers
take the plain versions that the other ``test_torch_*`` files check
against the JAX package. On a machine with a card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

The shapes cover what ``chip_smoke.py`` does not: for flash attention one
query row, head dims other than 64 (the kernel's 128-wide variant above
64), L at and around the 64-key tiles and 128-row CTAs up to 2048, q/k/v
views in another layout and of the QKV slab, and views that 16-byte
copies cannot take; for paged decode attention head dims 64 and 128,
blocks of 8 and 16 rows, table widths that split over clusters of 1 to 8
CTAs, positions on every split boundary, empty shares, one slot's output
bit-equal at every table width beside any co-runners, an out-of-pool
block id, grouped queries, pool slabs read through other strides, a
small generation engine whose every decode step goes through the kernel,
the same engine on the slot layout under each prefill mode and on the
paged layout under the chunked lane, and one pinned with
``engine_devices=[0]`` decoding as the unpinned one. The dedicated lane's
batched
kernels with padding rows on the scratch row and block (no device-side
assert, live rows untouched), an int8 paged engine that never launches
the paged kernel, and an int8 block's host-tier round trip. Speculative
decoding: both verify passes against serial decode steps in f32 and bf16
with the slots outside the round bit-unchanged, the salted noise
repeating (and its integer stream equal to the CPU's), and a small
speculating engine on both layouts.
The CUDA shared-memory data plane: a zero-copy in-process read, output
rows read back from the response callback of the pre-split path, and the
cross-process attachment's device copy held until the seqno moves. The
observability plane: a paged round scraped over HTTP with tracing off and
on, the same tokens and K2 launches in both. Supervision: a supervised
paged engine killed mid-stream and rebuilt on the card serves the same
tokens through K2, and the dead engine's device state is freed. The
goodput plane: a sampled dispatch waits on a CUDA event recorded on its
own stream, never on ``torch.cuda.synchronize()``, and a generator on the
card registers the MFU pair with the card's peak. The native stack: the
DIRECT model library's kernels (D1, ``libdirect_models_cuda.so``)
bit-equal to the CPU library at 1, 16 and 2^20 elements.
"""

import dataclasses

import numpy as np
import pytest
import torch

from client_tpu_torch.ops import flash_attention as fa
from client_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda

# kernel vs plain version on the card: f32, the two sum in other orders
# (the JAX suite's flash tolerance); bf16, one rounding of an O(1) output
# plus a probability that rounds the other way before PV
ATOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# paged decode attention vs its plain version: f32, the JAX suite's Pallas
# tolerance; bf16, one rounding of an O(1) output (P stays f32 in both)
PAGED_ATOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _randn(shape, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.float32).to(dtype)


@pytest.mark.parametrize("shape", [(2, 1, 3, 64), (2, 65, 2, 16),
                                   (1, 200, 3, 80), (1, 130, 2, 128),
                                   (3, 64, 4, 8)] + [
    # L around the 64-key tiles and 128-row CTAs, and a long sequence
    # through the double-buffered key loop
    (2, length, 2, head_dim) for length in (1, 63, 64, 65, 127, 129, 2048)
    for head_dim in (64, 128)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_version(card, dtype, causal, shape):
    q, k, v = (_randn(shape, dtype, seed) for seed in range(3))
    out = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ref = fa.flash_attention_reference(q, k, v, causal=causal)
    assert out.shape == q.shape and out.dtype == dtype
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=ATOL[dtype])


def test_flash_kernel_reads_other_layouts_through_strides(card):
    """q, k, v as [B, H, L, D] tensors seen as [B, L, H, D] views."""
    b, l, h, d = 2, 96, 3, 64
    q, k, v = (_randn((b, h, l, d), torch.bfloat16, s).transpose(1, 2)
               for s in range(3))
    assert not q.is_contiguous()
    out = fa.flash_attention(q, k, v)
    ref = fa.flash_attention_reference(q, k, v)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=ATOL[torch.bfloat16])


def test_flash_kernel_reads_the_qkv_slab_at_the_main_path_shape(card):
    """q, k, v as views of one [B, L, 3, H, D] tensor (row stride 3 H D),
    at the encoder's call: B 256, L 128, 12 heads of 64, bf16."""
    qkv = _randn((256, 128, 3, 12, 64), torch.bfloat16, 7)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out = fa.flash_attention(q, k, v)
    ref = fa.flash_attention_reference(q, k, v)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=ATOL[torch.bfloat16])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("view", ["offset", "odd_head_dim"])
def test_flash_kernel_takes_views_16_byte_copies_cannot(card, view, causal):
    """The wrapper's documented behaviour for a view that is not 16-byte
    aligned (a base one element off, or D not a multiple of 8): the
    scalar-load instantiation of the same kernel, the same result."""
    b, l, h, d = 2, 100, 3, 64 if view == "offset" else 36
    flat = _randn((3 * b * l * h * d + 1,), torch.bfloat16, 5)
    start = 1 if view == "offset" else 0
    q, k, v = (flat[start + i * b * l * h * d:
                    start + (i + 1) * b * l * h * d].view(b, l, h, d)
               for i in range(3))
    assert view != "offset" or q.data_ptr() % 16
    out = fa.flash_attention(q, k, v, causal=causal)
    ref = fa.flash_attention_reference(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=ATOL[torch.bfloat16])


def test_launches_count_each_kernel_launch(card):
    q = _randn((1, 32, 2, 64), torch.float32, 0)
    before = fa.launches
    fa.flash_attention(q, q, q)
    fa.flash_attention(q, q, q, causal=True)
    assert fa.launches == before + 2


def test_encoder_forward_goes_through_the_kernel(card):
    """A small encoder on the card: one launch per layer, and the same
    embedding as the plain attention's forward."""
    from client_tpu_torch.models import transformer as t
    from client_tpu_torch.perf.bench_harness import encoder_apply

    kw = dict(vocab_size=101, d_model=128, n_layers=3, n_heads=2,
              head_dim=64, d_ff=256, max_seq=48, causal=False,
              dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = t.init_params(gen, t.TransformerConfig(**kw))
    tokens = torch.randint(0, 101, (4, 48), device="cuda",
                           generator=gen, dtype=torch.int32)
    before = fa.launches
    got = encoder_apply(t.TransformerConfig(attn_impl="flash", **kw), params,
                        {"input_ids": tokens})["embedding"]
    assert fa.launches == before + 3
    want = encoder_apply(t.TransformerConfig(attn_impl="ref", **kw), params,
                         {"input_ids": tokens})["embedding"]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_card_inputs_ride_the_device_assembly_path(card):
    """Requests whose inputs already lie on the card are batched there
    (execute_parts_fused for single rows, execute_parts_ragged for
    several) and answered through the CUDA-event completion."""
    import threading

    from client_tpu_torch.models import make_add_sub
    from client_tpu_torch.server import TorchInferenceServer
    from client_tpu_torch.server.types import InferRequest, InferTensor

    core = TorchInferenceServer()
    core.register_model(make_add_sub("ab", 4, "FP32", max_batch_size=8,
                                     dynamic_batching=True), warmup=True)
    try:
        for rows in ((1, 1, 1), (2, 1, 3)):
            xs = [_randn((n, 4), torch.float32, 10 + i)
                  for i, n in enumerate(rows)]
            got, done, lock = {}, threading.Event(), threading.Lock()

            def cb(i):
                def f(resp, final):
                    with lock:
                        got[i] = resp
                        if len(got) == len(xs):
                            done.set()
                return f

            for i, x in enumerate(xs):
                req = InferRequest(model_name="ab", inputs=[
                    InferTensor("INPUT0", "FP32", tuple(x.shape),
                                device_array=x),
                    InferTensor("INPUT1", "FP32", tuple(x.shape),
                                device_array=2 * x)])
                core.infer(req, response_callback=cb(i))
            assert done.wait(60)
            for i, x in enumerate(xs):
                assert got[i].error is None, got[i].error
                out = got[i].output("OUTPUT0").data
                torch.testing.assert_close(torch.from_numpy(out),
                                           3 * x.cpu(), rtol=0, atol=1e-6)
    finally:
        core.stop()


def test_cuda_shm_in_process_read_is_zero_copy(card):
    """An in-process region's registered tensor is what the server reads:
    the same storage, after the producer's copy has landed."""
    from client_tpu_torch.utils import cuda_shared_memory as cudashm

    h = cudashm.create_shared_memory_region("zc", 4096)
    try:
        data = np.arange(1024, dtype=np.float32)
        cudashm.set_shared_memory_region(h, [data])
        att = cudashm.attach_from_raw_handle(cudashm.get_raw_handle(h))
        assert isinstance(att, cudashm.InProcessAttachment)
        got = att.read_array(0, data.nbytes, "FP32", (1024,))
        assert got.is_cuda
        assert got.data_ptr() == h.device_tensors[0][0].data_ptr()
        np.testing.assert_array_equal(got.cpu().numpy(), data)
    finally:
        cudashm.destroy_shared_memory_region(h)


def test_cuda_shm_output_rows_read_back_right_after_the_response(card):
    """The pre-split path on the card: each request's output region, read
    from its response callback, holds its own row, not stale bytes."""
    import threading

    from client_tpu_torch.models import make_add_sub
    from client_tpu_torch.perf.client_backend import (
        InProcessBackend,
        PerfInput,
        PerfRequestedOutput,
    )
    from client_tpu_torch.server import TorchInferenceServer
    from client_tpu_torch.utils import cuda_shared_memory as cudashm

    n, width = 24, 256
    model = make_add_sub("ab", width, "FP32", max_batch_size=32,
                         dynamic_batching=True)
    core = TorchInferenceServer()
    core.register_model(model, warmup=True)
    backend = InProcessBackend(core)
    rng = np.random.default_rng(0)
    handles, got, errors = [], {}, []
    done, lock = threading.Event(), threading.Lock()
    try:
        calls0 = model.fused_split_calls
        for rnd in range(3):
            xs = rng.standard_normal((n, 1, width)).astype(np.float32)
            reqs = []
            for i in range(n):
                h_in = cudashm.create_shared_memory_region(
                    f"in{rnd}_{i}", 2 * xs[i].nbytes)
                h_out = cudashm.create_shared_memory_region(
                    f"out{rnd}_{i}", xs[i].nbytes)
                handles += [h_in, h_out]
                cudashm.set_shared_memory_region(h_in, [xs[i], 2 * xs[i]])
                for h in (h_in, h_out):
                    backend.register_cuda_shared_memory(
                        h.name, cudashm.get_raw_handle(h), 0, h.byte_size)
                a = PerfInput("INPUT0", [1, width], "FP32")
                a.set_shared_memory(h_in.name, xs[i].nbytes)
                b = PerfInput("INPUT1", [1, width], "FP32")
                b.set_shared_memory(h_in.name, xs[i].nbytes, xs[i].nbytes)
                o = PerfRequestedOutput("OUTPUT0")
                o.set_shared_memory(h_out.name, xs[i].nbytes)
                reqs.append(([a, b], [o], h_out))
            got.clear()
            done.clear()

            def cb(i, h_out):
                def f(result, error):
                    with lock:
                        if error is not None:
                            errors.append(error)
                        got[i] = cudashm.get_contents_as_numpy(
                            h_out, np.float32, (1, width)).copy()
                        if len(got) == n:
                            done.set()
                return f

            for i, (ins, outs, h_out) in enumerate(reqs):
                backend.async_infer(cb(i, h_out), "ab", ins, outs)
            assert done.wait(60) and not errors, errors
            for i in range(n):
                np.testing.assert_allclose(got[i], 3 * xs[i], rtol=0,
                                           atol=1e-6)
        assert model.fused_split_calls > calls0
    finally:
        core.stop()
        for h in handles:
            cudashm.destroy_shared_memory_region(h)


def test_cuda_shm_cross_process_cache_holds_until_the_seqno_moves(card):
    """The cross-process attachment copies the staging bytes to the card
    once and serves that copy until the producer's seqno moves."""
    from client_tpu_torch.utils import cuda_shared_memory as cudashm

    h = cudashm.create_shared_memory_region("xp", 256)
    try:
        a = np.arange(64, dtype=np.int32)
        cudashm.set_shared_memory_region(h, [a])
        att = cudashm.CrossProcessAttachment(
            cudashm.parse_raw_handle(cudashm.get_raw_handle(h)))
        try:
            first = att.read_array(0, a.nbytes, "INT32", (64,))
            again = att.read_array(0, a.nbytes, "INT32", (64,))
            assert first.is_cuda and again.data_ptr() == first.data_ptr()
            np.testing.assert_array_equal(first.cpu().numpy(), a)
            cudashm.set_shared_memory_region(h, [a + 1])
            moved = att.read_array(0, a.nbytes, "INT32", (64,))
            assert moved.data_ptr() != first.data_ptr()
            np.testing.assert_array_equal(moved.cpu().numpy(), a + 1)
        finally:
            att.detach()
    finally:
        cudashm.destroy_shared_memory_region(h)


def _paged_case(s, h, hkv, dh, bl, n, width, dtype, seed, layout="plain"):
    """q, one layer's K/V slabs, tables of distinct blocks, positions from
    0 to past the table. ``layout`` "layer_major" takes the slabs as views
    of a [L, N, bl, Hkv, Dh] pool, "heads_outer" as views of a pool stored
    [N, Hkv, bl, Dh] (another stride for every dim but the last)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((s, h, dh), generator=gen, device="cuda").to(dtype)

    def slab():
        if layout == "layer_major":
            return torch.randn((3, n, bl, hkv, dh), generator=gen,
                               device="cuda").to(dtype)[2]
        if layout == "heads_outer":
            return torch.randn((n, hkv, bl, dh), generator=gen,
                               device="cuda").to(dtype).transpose(1, 2)
        return torch.randn((n, bl, hkv, dh), generator=gen,
                           device="cuda").to(dtype)

    kp, vp = slab(), slab()
    perm = torch.randperm(n - 1, generator=gen, device="cuda") + 1
    tables = perm[:s * width].reshape(s, width).to(torch.int32)
    span = width * bl
    pos = torch.linspace(0, span + bl, s, device="cuda").to(torch.int32)
    return q, kp, vp, tables, pos


@pytest.mark.parametrize("layout", ["plain", "layer_major", "heads_outer"])
@pytest.mark.parametrize("shape", [
    # S, H, Hkv, Dh, block_len, N, table width
    (5, 4, 4, 64, 16, 64, 6), (5, 8, 2, 128, 16, 64, 6),
    (7, 6, 3, 64, 8, 96, 10), (3, 32, 8, 128, 8, 40, 9),
    (4, 2, 1, 40, 16, 20, 3),
    # r = 4 query rows per KV head at Dh 128, through a cluster of 4
    (5, 16, 4, 128, 16, 61, 12)] + [
    # table widths whose cluster shares are single, uneven (7 over 3
    # CTAs) and long (64 over 8)
    (6, 12, 12, 64, 16, 6 * width + 1, width)
    for width in (1, 2, 3, 7, 12, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_matches_plain_version(card, dtype, shape, layout):
    args = _paged_case(*shape, dtype=dtype, seed=sum(shape), layout=layout)
    out = pa.paged_decode_attention(*args)
    torch.cuda.synchronize()
    ref = pa.paged_decode_attention_reference(*args)
    assert out.shape == args[0].shape and out.dtype == dtype
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=PAGED_ATOL[dtype])


def test_paged_kernel_inactive_slots_read_scratch(card):
    """Slots at position 0 on an all-scratch table attend row 0 of block 0
    only: their output is that row's V."""
    q, kp, vp, tables, pos = _paged_case(4, 4, 2, 64, 16, 32, 4,
                                         torch.float32, 3)
    tables[1:3] = 0
    pos[1:3] = 0
    out = pa.paged_decode_attention(q, kp, vp, tables, pos)
    want = vp[0, 0].repeat_interleave(2, dim=0)          # [H, Dh]
    torch.testing.assert_close(out[1], want, rtol=0, atol=1e-6)
    torch.testing.assert_close(out[2], want, rtol=0, atol=1e-6)


def _k2_check(args, dtype):
    out = pa.paged_decode_attention(*args)
    torch.cuda.synchronize()
    ref = pa.paged_decode_attention_reference(*args)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=PAGED_ATOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_positions_on_every_split_boundary(card, dtype):
    """Width 12 (a cluster of 4): a slot at each block's last and first
    row, so every share boundary of every live count is crossed."""
    width, bl = 12, 16
    pos = [0] + [p for b in range(1, width + 1) for p in (b * bl - 1, b * bl)]
    q, kp, vp, tables, _ = _paged_case(len(pos), 12, 12, 64, bl,
                                       len(pos) * width + 1, width, dtype, 3)
    _k2_check((q, kp, vp, tables,
               torch.tensor(pos, dtype=torch.int32, device="cuda")), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_fewer_live_blocks_than_ctas(card, dtype):
    """Width 12 (a cluster of 4) with 1 to 3 live blocks: some CTAs of
    the cluster have no share and must add exactly nothing."""
    q, kp, vp, tables, _ = _paged_case(6, 8, 4, 64, 16, 6 * 12 + 1, 12,
                                       dtype, 4)
    pos = torch.tensor([0, 5, 15, 16, 31, 47], dtype=torch.int32,
                       device="cuda")
    _k2_check((q, kp, vp, tables, pos), dtype)


def test_paged_kernel_out_of_pool_block_gives_nan_in_its_slot_only(card):
    """A live table entry outside [0, N) makes that slot's output NaN, as
    the kernel reads nothing out of bounds; the other slots are unharmed,
    whichever CTA of their clusters holds the entry."""
    q, kp, vp, tables, pos = _paged_case(4, 4, 4, 64, 16, 4 * 12 + 1, 12,
                                         torch.float32, 6)
    n = kp.shape[0]
    pos[:] = 12 * 16 - 1
    tables[1, 10] = n            # in the last CTA's share
    tables[2, 0] = -1            # in the first CTA's share
    out = pa.paged_decode_attention(q, kp, vp, tables, pos)
    torch.cuda.synchronize()
    assert torch.isnan(out[1]).all() and torch.isnan(out[2]).all()
    good = [0, 3]
    ref = pa.paged_decode_attention_reference(
        q[good], kp, vp, tables[good], pos[good])
    torch.testing.assert_close(out[good], ref, rtol=0,
                               atol=PAGED_ATOL[torch.float32])


# (position, table widths): live 1, 3, 7 and 12 padded to every width up
# to 12 (clusters of 1 to 4 CTAs); live 25 (C = 8, shares of 4 blocks) at
# widths 26, 32 and 48
_WIDTH_CASES = [(5, range(1, 13)), (37, range(3, 13)), (100, range(7, 13)),
                (191, range(12, 13)), (390, (25, 26, 32, 48))]


@pytest.mark.parametrize("heads", [(12, 12), (16, 4)], ids=["mha", "gqa4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_slot_output_is_bit_equal_at_every_table_width(
        card, dtype, heads):
    """One slot's output depends on its own q, blocks and position only:
    launched alone at its own table width, and padded to every wider width
    beside co-runners at longer positions (which set the launch's cluster
    size), it is bit-equal in every launch."""
    h, hkv = heads
    dh, bl, runners = 64, 16, 3
    n = 1 + 48 * (runners + 1)
    gen = torch.Generator(device="cuda").manual_seed(29)
    q = torch.randn((runners + 1, h, dh), generator=gen,
                    device="cuda").to(dtype)
    kp = torch.randn((n, bl, hkv, dh), generator=gen, device="cuda").to(dtype)
    vp = torch.randn((n, bl, hkv, dh), generator=gen, device="cuda").to(dtype)
    blocks = (torch.randperm(n - 1, generator=gen, device="cuda") + 1).to(
        torch.int32).reshape(runners + 1, 48)
    for p, widths in _WIDTH_CASES:
        live = p // bl + 1
        own = pa.paged_decode_attention(
            q[:1], kp, vp, blocks[:1, :live].contiguous(),
            torch.tensor([p], dtype=torch.int32, device="cuda"))
        for w in widths:
            tables = blocks[:, :w].clone()
            tables[0, live:] = 0                     # padding: scratch block
            pos = torch.tensor([p] + [w * bl - 1 - i for i in range(runners)],
                               dtype=torch.int32, device="cuda")
            out = pa.paged_decode_attention(q, kp, vp, tables, pos)
            torch.cuda.synchronize()
            assert torch.equal(out[0], own[0]), (p, w)
        _k2_check((q[:1], kp, vp, blocks[:1, :live].contiguous(),
                   torch.tensor([p], dtype=torch.int32, device="cuda")),
                  dtype)


@pytest.mark.parametrize("view", ["offset", "odd_head_dim"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_takes_pools_16_byte_copies_cannot(card, dtype, view):
    """Pool slabs one element off a 16-byte boundary, or a head dim that
    is not a whole number of 16-byte chunks: the scalar-load
    instantiation of the same kernel, the same result."""
    dh = 64 if view == "offset" else 36
    q, kp, vp, tables, pos = _paged_case(4, 8, 2, dh, 16, 4 * 12 + 1, 12,
                                         dtype, 11)
    if view == "offset":
        flat = torch.empty(kp.numel() + 1, dtype=dtype, device="cuda")
        kp = flat[1:].view(kp.shape).copy_(kp)
        assert kp.data_ptr() % 16
    _k2_check((q, kp, vp, tables, pos), dtype)


def test_paged_kernel_launch_counter(card):
    args = _paged_case(2, 2, 2, 64, 16, 8, 2, torch.bfloat16, 0)
    before = pa.launches
    pa.paged_decode_attention(*args)
    pa.paged_decode_attention(*args)
    assert pa.launches == before + 2


def test_pinned_engine_on_the_card_decodes_as_the_unpinned_one(card):
    """``engine_devices=[0]`` puts every tensor of a paged engine on
    cuda:0, and its greedy streams (through K2) equal the unpinned
    engine's token for token."""
    from client_tpu_torch.models import transformer as t
    from client_tpu_torch.server.generation import ContinuousBatchingEngine

    cfg = t.TransformerConfig(vocab_size=97, d_model=64, n_layers=2,
                              n_heads=4, head_dim=16, d_ff=128, max_seq=64,
                              dtype=torch.bfloat16, attn_impl="flash")
    params = t.init_params(torch.Generator(device="cuda").manual_seed(0),
                           cfg)
    kw = dict(n_slots=2, chunk=4, kv_layout="paged", kv_block_len=8)
    free = ContinuousBatchingEngine(cfg, params, device="cuda", **kw)
    pinned = ContinuousBatchingEngine(cfg, params, engine_devices=[0], **kw)
    try:
        prompt = np.arange(1, 20, dtype=np.int32)
        want = list(free.submit(prompt, 12))
        before = pa.launches
        assert list(pinned.submit(prompt, 12)) == want
        assert pa.launches > before
        assert pinned._device == torch.device("cuda", 0)
        assert {p.device for p in pinned._dev["params"]["layers"].values()} \
            == {torch.device("cuda", 0)}
    finally:
        free.stop()
        pinned.stop()


def test_small_engine_goes_through_the_paged_kernel(card):
    """A small f32 engine on the card: K2 launches n_layers x chunk times
    per chunk dispatch, and its greedy streams equal the same weights'
    S=1 decode through the plain K2."""
    from client_tpu_torch.models import transformer as t
    from client_tpu_torch.models.sampling import offline_sample
    from client_tpu_torch.perf.bench_harness import (
        ragged_generation_jobs,
        run_engine_jobs,
    )
    from client_tpu_torch.server.generation import ContinuousBatchingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = t.TransformerConfig(vocab_size=97, d_model=64, n_layers=2,
                              n_heads=4, head_dim=16, d_ff=128, max_seq=64,
                              dtype=torch.float32, attn_impl="flash")
    params = t.init_params(torch.Generator(device="cuda").manual_seed(0),
                           cfg)
    jobs = ragged_generation_jobs(3, 97, 6, (1, 20), (3, 30), 64)
    eng = ContinuousBatchingEngine(cfg, params, n_slots=4, chunk=4,
                                   kv_layout="paged", kv_block_len=8,
                                   device="cuda").start()
    try:
        list(eng.submit(np.zeros(3, np.int32), 2))   # engine ready
        chunks0, before = eng.stats()["chunks_dispatched"], pa.launches
        _, _, toks = run_engine_jobs(eng, jobs, collect=True,
                                     join_timeout_s=300)
        chunks = eng.stats()["chunks_dispatched"] - chunks0
        assert pa.launches - before == 2 * 4 * chunks
    finally:
        eng.stop()
    for (prompt, budget), got in zip(jobs, toks):
        want = offline_sample(cfg, params, prompt, budget, block_len=8,
                              attention=pa.paged_decode_attention_reference)
        assert got == want


@pytest.mark.parametrize("kw", [
    dict(), dict(prefill_mode="batched"),
    dict(prefill_mode="chunked", prefill_chunk=16),
    dict(kv_layout="paged", kv_block_len=8, prefill_mode="chunked",
         prefill_chunk=16)], ids=["slot_token", "slot_batched",
                                  "slot_chunked", "paged_chunked"])
def test_small_engine_layouts_and_prefill_modes_on_the_card(card, kw):
    """A small f32 engine on the card under the slot layout (each prefill
    mode) and the paged chunked lane: greedy streams equal the same
    weights' S=1 decode through the plain K2; K2 launches only on the
    paged layout, n_layers x chunk per chunk dispatch (lane riders
    included), and the lane dispatched chunks."""
    from client_tpu_torch.models import transformer as t
    from client_tpu_torch.models.sampling import offline_sample
    from client_tpu_torch.perf.bench_harness import (
        ragged_generation_jobs,
        run_engine_jobs,
    )
    from client_tpu_torch.server.generation import ContinuousBatchingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = t.TransformerConfig(vocab_size=97, d_model=64, n_layers=2,
                              n_heads=4, head_dim=16, d_ff=128, max_seq=64,
                              dtype=torch.float32, attn_impl="flash")
    params = t.init_params(torch.Generator(device="cuda").manual_seed(0),
                           cfg)
    jobs = ragged_generation_jobs(5, 97, 6, (1, 40), (3, 20), 64)
    eng = ContinuousBatchingEngine(cfg, params, n_slots=4, chunk=4,
                                   device="cuda", **kw).start()
    try:
        list(eng.submit(np.zeros(3, np.int32), 2))   # engine ready
        stats0, before = eng.stats(), pa.launches
        _, _, toks = run_engine_jobs(eng, jobs, collect=True,
                                     join_timeout_s=300)
        stats = eng.stats()
    finally:
        eng.stop()
    chunks = stats["chunks_dispatched"] - stats0["chunks_dispatched"]
    paged = kw.get("kv_layout") == "paged"
    assert pa.launches - before == (2 * 4 * chunks if paged else 0)
    if "prefill_chunk" in kw:
        assert stats["prefill_lane"]["chunks"] > 0
    for (prompt, budget), got in zip(jobs, toks):
        want = offline_sample(cfg, params, prompt, budget, block_len=8,
                              attention=pa.paged_decode_attention_reference)
        assert got == want


# speculative verify vs serial decode on the card. f32 (TF32 off): the
# batched and serial forwards sum in other orders, 1e-4 on logits of O(1).
# bf16: every activation is rounded to bf16 (~4e-3 relative) at other
# places by the T-row and one-row products; over 2 layers a K/V row moves
# by a few bf16 roundings and a logit by a few hundredths
VERIFY_ATOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (3e-2, 8e-2)}


def _verify_model(dtype):
    from client_tpu_torch.models import transformer as t

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = t.TransformerConfig(vocab_size=97, d_model=64, n_layers=2,
                              n_heads=4, head_dim=16, d_ff=128, max_seq=64,
                              dtype=dtype, attn_impl="ref")
    params = t.init_params(torch.Generator(device="cuda").manual_seed(0),
                           cfg)
    return t, cfg, params


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_verify_steps_match_serial_decode_on_the_card(card, dtype):
    """verify_steps of 5 tokens on 2 of 3 slots from mid-sequence: the
    logits and rows of 5 serial decode_step calls, and the third slot
    bit-unchanged."""
    t, cfg, params = _verify_model(dtype)
    kv_atol, logit_atol = VERIFY_ATOL[dtype]
    gen = torch.Generator(device="cuda").manual_seed(1)
    pre = torch.randint(0, 97, (3, 9), generator=gen, device="cuda",
                        dtype=torch.int32)
    toks = torch.randint(0, 97, (2, 5), generator=gen, device="cuda",
                         dtype=torch.int32)
    st = t.init_decode_state(cfg, 3, "cuda")
    for c in range(9):
        _, st = t.decode_step(cfg, params, pre[:, c], st)
    serial = {k: v.clone() for k, v in st.items()}
    rows = torch.tensor([2, 0], device="cuda")
    logits, st = t.verify_steps(cfg, params, toks, st, rows=rows)
    torch.cuda.synchronize()
    assert st["pos"].tolist() == [14, 9, 14]
    assert torch.equal(st["k"][1], serial["k"][1])
    assert torch.equal(st["v"][1], serial["v"][1])
    for c in range(5):
        want, serial = t.decode_step(cfg, params, toks[:, c], serial,
                                     rows=rows)
        torch.testing.assert_close(logits[:, c], want, rtol=0,
                                   atol=logit_atol)
    for name in ("k", "v"):
        torch.testing.assert_close(st[name].float(), serial[name].float(),
                                   rtol=0, atol=kv_atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_verify_steps_match_serial_paged_decode_on_the_card(card,
                                                                 dtype):
    """paged_verify_steps of 4 tokens per slot with one slot outside the
    write mask: the verifying slots' logits and pool rows are those of 4
    serial paged_decode_steps (the einsum attention), and the other slot's
    blocks are bit-unchanged."""
    from client_tpu_torch.server.kv_cache import init_paged_pool

    t, cfg, params = _verify_model(dtype)
    kv_atol, logit_atol = VERIFY_ATOL[dtype]
    gen = torch.Generator(device="cuda").manual_seed(2)
    pre = torch.randint(0, 97, (3, 11), generator=gen, device="cuda",
                        dtype=torch.int32)
    toks = torch.randint(0, 97, (3, 4), generator=gen, device="cuda",
                         dtype=torch.int32)
    nb = cfg.max_seq // 8
    pool = init_paged_pool(cfg, 3 * nb + 1, 8, "cuda")
    tables = (1 + torch.arange(3 * nb, device="cuda")).reshape(3, nb).to(
        torch.int32)
    for c in range(11):
        t.paged_decode_steps(cfg, params, pre[:, c],
                             torch.full((3,), c, dtype=torch.int32,
                                        device="cuda"), tables, pool)
    serial = {k: v.clone() for k, v in pool.items()}
    write = torch.tensor([True, False, True], device="cuda")
    logits, pool = t.paged_verify_steps(
        cfg, params, toks, torch.full((3,), 11, dtype=torch.int32,
                                      device="cuda"), tables, pool, write)
    torch.cuda.synchronize()
    mine = tables[1].long()
    for name in ("k", "v"):
        assert torch.equal(pool[name][:, mine], serial[name][:, mine])
    for c in range(4):
        want, serial = t.paged_decode_steps(
            cfg, params, toks[:, c],
            torch.full((3,), 11 + c, dtype=torch.int32, device="cuda"),
            tables, serial)
        torch.testing.assert_close(logits[[0, 2], c], want[[0, 2]], rtol=0,
                                   atol=logit_atol)
    for name in ("k", "v"):
        for s in (0, 2):
            blocks = tables[s].long()
            torch.testing.assert_close(pool[name][:, blocks].float(),
                                       serial[name][:, blocks].float(),
                                       rtol=0, atol=kv_atol)


def test_salted_noise_repeats_on_the_card(card):
    """The speculation draws are pure functions of (seed, position, salt)
    on the card too: equal across two calls, and the integer stream equal
    to the CPU's."""
    from client_tpu_torch.models import sampling as s
    from client_tpu_torch.server.speculation import (
        ACCEPT_SALT,
        DRAFT_SALT,
        RESIDUAL_SALT,
    )

    seeds = torch.arange(16, device="cuda")
    pos = torch.arange(16, device="cuda") * 7
    for salt in (0, DRAFT_SALT, ACCEPT_SALT, RESIDUAL_SALT):
        a = s.step_gumbel(seeds, pos, 97, salt)
        b = s.step_gumbel(seeds, pos, 97, salt)
        assert torch.equal(a, b) and torch.isfinite(a).all()
        assert torch.equal(s.step_uniform(seeds, pos, salt),
                           s.step_uniform(seeds, pos, salt))
        assert torch.equal(s._step_bits(seeds, pos, 97, salt).cpu(),
                           s._step_bits(seeds.cpu(), pos.cpu(), 97, salt))


@pytest.mark.parametrize("kw", [dict(), dict(kv_layout="paged",
                                             kv_block_len=8)],
                         ids=["slot", "paged"])
def test_small_speculating_engine_on_the_card(card, kw):
    """A small f32 engine with a self-draft on the card: greedy streams
    equal the S=1 decode through the plain K2, rounds ran and accepted
    every proposal, and K2 launches n_layers x chunk per chunk dispatch
    only (verify rounds read through the einsum)."""
    from client_tpu_torch.models.sampling import offline_sample
    from client_tpu_torch.perf.bench_harness import (
        ragged_generation_jobs,
        run_engine_jobs,
    )
    from client_tpu_torch.server.generation import ContinuousBatchingEngine
    from client_tpu_torch.server.speculation import DraftModel

    t, cfg, params = _verify_model(torch.float32)
    cfg = dataclasses.replace(cfg, attn_impl="flash")
    jobs = ragged_generation_jobs(5, 97, 6, (1, 30), (3, 20), 64)
    eng = ContinuousBatchingEngine(
        cfg, params, n_slots=4, chunk=4, device="cuda",
        speculative_draft=DraftModel(cfg, params), speculative_gamma=4,
        **kw).start()
    try:
        list(eng.submit(np.zeros(3, np.int32), 2))   # engine ready
        stats0, before = eng.stats(), pa.launches
        _, _, toks = run_engine_jobs(eng, jobs, collect=True,
                                     join_timeout_s=300)
        stats = eng.stats()
    finally:
        eng.stop()
    kinds, kinds0 = stats["dispatch_by_kind"], stats0["dispatch_by_kind"]
    chunks = kinds["chunk"]["dispatches"] - kinds0["chunk"]["dispatches"]
    paged = kw.get("kv_layout") == "paged"
    assert pa.launches - before == (2 * 4 * chunks if paged else 0)
    spec = stats["speculation"]
    assert spec["rounds"] > 0 and spec["accepted"] == spec["proposed"]
    for (prompt, budget), got in zip(jobs, toks):
        want = offline_sample(cfg, params, prompt, budget, block_len=8,
                              attention=pa.paged_decode_attention_reference)
        assert got == want


# the host tier's movers and preemption on the card

def _tier_pool(layer_major: bool, dtype, seed: int) -> dict:
    """A random pool of 9 blocks of 8 rows, 2 layers, 2 KV heads of 64:
    layer-major as the paged layout keeps it, block-major as the slot
    layout's prefix pool."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (2, 9, 8, 2, 64) if layer_major else (9, 2, 8, 2, 64)
    return {name: torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for name in ("k", "v")}


def _block(pool: dict, bid: int, layer_major: bool) -> dict:
    return {name: (p[:, bid] if layer_major else p[bid]).clone()
            for name, p in pool.items()}


@pytest.mark.parametrize("layer_major", [True, False],
                         ids=["paged", "slot_prefix_pool"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tier_spill_and_restore_round_trip_bit_exact(card, layer_major,
                                                     dtype):
    """A block spilled to pinned host memory and restored into another
    block holds the same bits; the rows land on the host once the spill's
    event has completed; no other block changes."""
    from client_tpu_torch.server import kv_cache as kvc

    pool = _tier_pool(layer_major, dtype, 0)
    want = _block(pool, 3, layer_major)
    rows, ready = kvc.tier_spill(pool, 3, layer_major)
    assert ready is not None
    ready.synchronize()
    for name in pool:
        assert rows[name].is_pinned() and rows[name].device.type == "cpu"
        assert torch.equal(rows[name], want[name].cpu())
    before = {name: p.clone() for name, p in pool.items()}
    kvc.tier_restore(pool, 6, rows, layer_major)
    torch.cuda.synchronize()
    for name, p in pool.items():
        got = p[:, 6] if layer_major else p[6]
        assert torch.equal(got, want[name])
        keep = torch.ones(9, dtype=torch.bool, device="cuda")
        keep[6] = False
        if layer_major:
            assert torch.equal(p[:, keep], before[name][:, keep])
        else:
            assert torch.equal(p[keep], before[name][keep])
    assert kvc.pool_block_nbytes(pool, layer_major) \
        == 2 * 2 * 8 * 2 * 64 * pool["k"].element_size()


@pytest.mark.parametrize("layer_major", [True, False],
                         ids=["paged", "slot_prefix_pool"])
def test_tier_spill_then_overwrite_keeps_the_old_rows(card, layer_major):
    """The pool is written in place: a kernel that overwrites the block
    right after its spill was enqueued (as a reuse of the freed id does)
    must not reach the rows the spill copies."""
    from client_tpu_torch.server import kv_cache as kvc

    pool = _tier_pool(layer_major, torch.bfloat16, 1)
    want = _block(pool, 2, layer_major)
    rows, ready = kvc.tier_spill(pool, 2, layer_major)
    for p in pool.values():
        (p[:, 2] if layer_major else p[2]).fill_(7.0)
    ready.synchronize()
    for name in pool:
        assert torch.equal(rows[name], want[name].cpu())
    kvc.tier_restore(pool, 2, rows, layer_major)
    torch.cuda.synchronize()
    for name, p in pool.items():
        assert torch.equal(p[:, 2] if layer_major else p[2], want[name])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_over_a_restored_block_equals_the_unspilled_pool(card, dtype):
    """Spill a block that a slot's table names, overwrite it, restore it
    into a fresh block, point the table there, and launch K2 at once: the
    output equals K2 over the pool that never spilled."""
    from client_tpu_torch.server import kv_cache as kvc

    q, kp, vp, tables, pos = _paged_case(4, 4, 2, 64, 16, 24, 3, dtype, 5)
    want = pa.paged_decode_attention(q, kp, vp, tables, pos)
    pool = {"k": kp[None], "v": vp[None]}      # one layer, layer-major
    victim = int(tables[1, 1])
    fresh = next(b for b in range(1, 24)
                 if b not in set(tables.flatten().tolist()))
    rows, _ = kvc.tier_spill(pool, victim, True)
    for p in pool.values():
        p[:, victim].zero_()
    kvc.tier_restore(pool, fresh, rows, True)
    moved = tables.clone()
    moved[1, 1] = fresh
    got = pa.paged_decode_attention(q, kp, vp, moved, pos)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_paged_preempt_and_resume_through_k2(card):
    """A small f32 engine on the paged layout with one slot: a gold
    request arrives while a best-effort stream decodes, preempts it (its
    extended context donated to the trie and pinned), and the stream
    resumes through a table headed by its own committed chain, read by
    K2. Both streams equal their uninterrupted runs; one preemption, one
    resume; no pin, stream block or reservation is left."""
    import threading

    from client_tpu_torch.models import transformer as t
    from client_tpu_torch.server.generation import ContinuousBatchingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = t.TransformerConfig(vocab_size=97, d_model=64, n_layers=2,
                              n_heads=4, head_dim=16, d_ff=128, max_seq=64,
                              dtype=torch.float32, attn_impl="flash")
    params = t.init_params(torch.Generator(device="cuda").manual_seed(0),
                           cfg)
    eng = ContinuousBatchingEngine(
        cfg, params, n_slots=1, chunk=4, fetch_stride=1, device="cuda",
        kv_layout="paged", kv_block_len=8, prefix_cache=True,
        prefix_block_len=8, prefill_mode="chunked", prefill_chunk=16,
        slo_classes=[{"name": "gold", "ttft_ms": 1000.0}],
        scheduler={"class_weights": {"gold": 8.0}, "preemption": True,
                   "preempt_burn_threshold": 0.0}).start()
    be_prompt = np.arange(1, 21, dtype=np.int32)
    gold_prompt = np.asarray([40, 41, 42, 43, 44], np.int32)
    held, go = threading.Event(), threading.Event()
    sweep = eng._reap_slots

    def reap():
        if not go.is_set() and any(
                s.req is not None and s.req.tenant == "flood"
                and s.req.emitted >= 4 for s in eng._slots):
            held.set()
            go.wait(120)
        sweep()

    try:
        plain_be = list(eng.submit(be_prompt, 36))
        plain_gold = list(eng.submit(gold_prompt, 8))
        eng._reap_slots = reap
        before = pa.launches
        out = {}
        th = threading.Thread(target=lambda: out.__setitem__(
            "be", list(eng.submit(be_prompt, 36, tenant_id="flood"))))
        th.start()
        assert held.wait(120)
        gold_it = eng.submit(gold_prompt, 8, tenant_id="vip",
                             slo_class="gold")
        go.set()
        out["gold"] = list(gold_it)
        th.join(120)
        assert eng.drain(timeout=60)
        sched = eng.scheduler_snapshot()
        occ = eng._kv_index.occupancy()
        pins = eng._kv_index.pinned_nodes()
    finally:
        eng.stop()
    assert out == {"be": plain_be, "gold": plain_gold}
    assert sched["preemptions_total"] == sched["resumes_total"] == 1
    assert pa.launches > before
    assert pins == 0 and occ["stream"] == 0 and occ["reserved"] == 0


# ------------------------------------------- dedicated lanes and int8 KV

def _lane_model(kv_quant=False):
    from client_tpu_torch.models import transformer as t

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = t.TransformerConfig(vocab_size=97, d_model=64, n_layers=2,
                              n_heads=4, head_dim=16, d_ff=128, max_seq=64,
                              dtype=torch.float32, attn_impl="flash",
                              kv_quant=kv_quant)
    params = t.init_params(torch.Generator(device="cuda").manual_seed(0),
                           cfg)
    return cfg, params


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_batched_lane_with_padding_rows_on_the_card(card, layout):
    """The batched lane kernels with two real rows and two padding rows
    (the lane state's scratch row; paged: all-zero tables): no device-side
    assert, the first tokens, positions and written rows equal the same
    call on the CPU, and the live lane row outside the batch, the rows of
    the real slots outside their chunks and (paged) every block no row
    owns stay bit-unchanged."""
    from client_tpu_torch.models import transformer as t
    from client_tpu_torch.server import generation as g
    from client_tpu_torch.server import kv_cache as kvc

    cfg, params = _lane_model()
    n_lane, bl = 3, 8
    toks = torch.randint(0, 97, (4, 16), generator=torch.Generator()
                         .manual_seed(1), dtype=torch.int32)
    rows = torch.tensor([0, 2, n_lane, n_lane])
    pos0 = torch.tensor([0, 16, 0, 0], dtype=torch.int32)
    clen = torch.tensor([16, 9, 1, 1], dtype=torch.int32)
    finals = torch.tensor([False, True, False, False])
    sampling = (torch.zeros(4, dtype=torch.int32), torch.zeros(4),
                torch.zeros(4, dtype=torch.int32), torch.zeros(4))
    tables = torch.zeros((4, cfg.max_seq // bl), dtype=torch.int32)
    tables[0] = torch.arange(1, 9)
    tables[1] = torch.arange(9, 17)
    if layout == "slot":
        init = t.init_decode_state(cfg, n_lane + 1, "cpu")
        init.pop("pos")
    else:
        init = kvc.init_paged_pool(cfg, 20, bl, "cpu")
    gen = torch.Generator().manual_seed(2)
    for arr in init.values():
        arr.normal_(generator=gen)
    outs = {}
    for dev in ("cpu", "cuda"):
        p = {k: (v.to(dev) if not isinstance(v, dict)
                 else {n: w.to(dev) for n, w in v.items()})
             for k, v in params.items()}
        pos = torch.zeros(n_lane + 1, dtype=torch.int32, device=dev)
        last = torch.full((n_lane + 1,), 7, dtype=torch.int32, device=dev)
        args = [x.to(dev) for x in (rows, toks, pos0, clen, finals)]
        samp = tuple(x.to(dev) for x in sampling)
        state = {n: a.to(dev) for n, a in init.items()}
        before = {n: a.clone() for n, a in state.items()}
        if layout == "slot":
            g.lane_batch_kernel(cfg, p, state, pos, last, *args, samp)
        else:
            r, tk, p0, cl, fi = args
            g.paged_lane_batch(cfg, p, state, pos, last, r, tables.to(dev),
                               tk, p0, cl, fi, samp)
        if dev == "cuda":
            torch.cuda.synchronize()
        outs[dev] = (pos.cpu(), last.cpu(),
                     {n: a.cpu() for n, a in state.items()},
                     {n: a.cpu() for n, a in before.items()})
    (cpos, clast, cstate, _), (gpos, glast, gstate, gbefore) = \
        outs["cpu"], outs["cuda"]
    assert gpos[:n_lane].tolist() == cpos[:n_lane].tolist() == [16, 0, 25]
    assert glast[:n_lane].tolist() == clast[:n_lane].tolist()
    assert glast[0] == 7 and glast[1] == 7
    for name in gstate:
        if layout == "slot":
            assert torch.equal(gstate[name][1], gbefore[name][1])
            assert torch.equal(gstate[name][2][:, :16],
                               gbefore[name][2][:, :16])
            torch.testing.assert_close(gstate[name][[0, 2]],
                                       cstate[name][[0, 2]], rtol=0,
                                       atol=1e-4)
        else:
            assert torch.equal(gstate[name][:, 17:], gbefore[name][:, 17:])
            torch.testing.assert_close(gstate[name][:, 1:17],
                                       cstate[name][:, 1:17], rtol=0,
                                       atol=1e-4)


def test_int8_paged_engine_never_launches_k2(card):
    """A small paged engine with attn_impl="flash" under kv_quant serves
    its streams through the dequantising einsum (0 K2 launches, as in the
    reference), equal to the same engine on the CPU; its twin without
    kv_quant launches K2 on every chunk step."""
    from client_tpu_torch.perf.bench_harness import (
        ragged_generation_jobs,
        run_engine_jobs,
    )
    from client_tpu_torch.server.generation import ContinuousBatchingEngine

    jobs = ragged_generation_jobs(3, 97, 6, (1, 40), (3, 20), 64)
    launched, streams = {}, {}
    for quant, dev in ((True, "cuda"), (True, "cpu"), (False, "cuda")):
        cfg, params = _lane_model(kv_quant=quant)
        if dev == "cpu":
            params = {k: (v.cpu() if not isinstance(v, dict)
                          else {n: w.cpu() for n, w in v.items()})
                      for k, v in params.items()}
        eng = ContinuousBatchingEngine(
            cfg, params, n_slots=4, chunk=4, kv_layout="paged",
            kv_block_len=8, prefill_mode="chunked", prefill_chunk=16,
            device=dev).start()
        try:
            before = pa.launches
            _, _, toks = run_engine_jobs(eng, jobs, collect=True,
                                         join_timeout_s=300)
            launched[(quant, dev)] = pa.launches - before
            streams[(quant, dev)] = toks
        finally:
            eng.stop()
    assert launched[(True, "cuda")] == 0
    assert launched[(False, "cuda")] > 0
    assert streams[(True, "cuda")] == streams[(True, "cpu")]


@pytest.mark.parametrize("layer_major", [True, False],
                         ids=["paged", "slot_prefix_pool"])
def test_int8_block_tier_round_trip_on_the_card(card, layer_major):
    """An int8 block and its scale tables spilled to pinned host memory
    and restored into another block hold the same bits."""
    from client_tpu_torch.server import kv_cache as kvc

    cfg, _ = _lane_model(kv_quant=True)
    init = kvc.init_paged_pool if layer_major else kvc.init_block_pool
    pool = init(cfg, 9, 8, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    for arr in pool.values():
        if arr.dtype == torch.int8:
            arr.copy_(torch.randint(-127, 128, arr.shape, generator=gen,
                                    device="cuda", dtype=torch.int8))
        else:
            arr.uniform_(1e-3, 5e-2, generator=gen)
    assert sorted(pool) == ["k", "k_scale", "v", "v_scale"]
    rows, ready = kvc.tier_spill(pool, 3, layer_major)
    ready.synchronize()
    kvc.tier_restore(pool, 6, rows, layer_major)
    torch.cuda.synchronize()
    for name, p in pool.items():
        src, dst = (p[:, 3], p[:, 6]) if layer_major else (p[3], p[6])
        assert torch.equal(dst, src), name
    assert kvc.pool_block_nbytes(pool, layer_major) \
        == 2 * 2 * 8 * 4 * (16 + 4)


def test_traced_paged_round_scraped_over_http(card):
    """A small paged generator (K2 on every chunk step) behind the HTTP
    front end serves the same greedy jobs with tracing off and with
    ``trace_rate`` 1: the same tokens, the same K2 launches, one trace per
    stream from REQUEST_START to REQUEST_END, and ``/metrics`` over HTTP
    whose token and completion counters equal the engine's."""
    import urllib.request

    from client_tpu_torch.models.decoder_lm import make_continuous_generator
    from client_tpu_torch.perf.bench_harness import ragged_generation_jobs
    from client_tpu_torch.server import TorchInferenceServer
    from client_tpu_torch.server.http_server import HttpInferenceServer
    from client_tpu_torch.server.metrics import (
        parse_prometheus_text,
        sample_value,
    )
    from client_tpu_torch.server.types import InferRequest, InferTensor

    cfg, params = _lane_model()
    jobs = ragged_generation_jobs(3, 97, 6, (1, 40), (3, 20), 64)
    runs = {}
    for traced in (False, True):
        core = TorchInferenceServer()
        core.register_model(make_continuous_generator(
            "lm", cfg=cfg, params=params, n_slots=4, chunk_size=4,
            kv_layout="paged", kv_block_len=8, device="cuda"), warmup=True)
        engine = core._entry("lm").model.engine
        http = HttpInferenceServer(core, port=0).start()
        if traced:
            core.update_trace_settings(settings={
                "trace_level": ["TIMESTAMPS"], "trace_rate": "1"})
        streams = [[] for _ in jobs]

        def one(i):
            prompt, budget = jobs[i]
            req = InferRequest(model_name="lm", inputs=[
                InferTensor("PROMPT", "INT32", (len(prompt),), data=prompt),
                InferTensor("MAX_TOKENS", "INT32", (1,),
                            data=np.asarray([budget], np.int32))])
            core.infer(req, response_callback=lambda r, f: r.outputs and
                       streams[i].append(int(r.outputs[0].data[0])))

        try:
            # one after another: the dispatch count, and so K2's launches,
            # do not depend on when the streams arrive
            before = pa.launches
            chunks0 = engine.stats()["chunks_dispatched"]
            for i in range(len(jobs)):
                one(i)
            launches = pa.launches - before
            with urllib.request.urlopen(f"http://{http.url}/metrics",
                                        timeout=60) as r:
                parsed = parse_prometheus_text(r.read().decode())
            stats = engine.stats()
            traces = list(core.tracer.completed)
        finally:
            http.stop()
            core.stop()
        lab = {"model": "lm"}
        assert sample_value(parsed, "client_tpu_generation_tokens_total",
                            lab) == stats["tokens_emitted"]
        assert sample_value(parsed, "client_tpu_generation_requests_total",
                            lab) == stats["requests_completed"] \
            == len(jobs) + 1   # and the warmup stream
        assert sample_value(parsed, "client_tpu_engine_up", lab) == 1
        # 2 layers x 4 steps per chunk dispatch
        assert launches == 2 * 4 * (stats["chunks_dispatched"] - chunks0)
        runs[traced] = (streams, launches, traces)
    assert runs[True][0] == runs[False][0]
    assert runs[True][1] == runs[False][1] > 0
    assert runs[False][2] == []
    assert len(runs[True][2]) == len(jobs)
    for tr in runs[True][2]:
        names = [s[0] for s in tr.timestamps]
        assert names[0] == "REQUEST_START" and names[-1] == "REQUEST_END"


def test_supervised_restart_on_the_card_frees_the_dead_engine(card):
    """A small supervised paged generator (K2 on every chunk step) killed
    by an ``engine_loop`` fault mid-stream: the stream gets a 503 with
    ``Retry-After``, the supervisor rebuilds the engine on the card, the
    same greedy stream comes back token for token with K2 at 2 x 4
    launches per chunk dispatch on the rebuilt engine, and
    ``memory_allocated`` comes back to one engine's state (the dead
    engine's pool is freed, not held beside the new one)."""
    import gc
    import time

    from client_tpu_torch.models.decoder_lm import make_continuous_generator
    from client_tpu_torch.server import faultinject
    from client_tpu_torch.server.types import ServerError

    cfg, params = _lane_model()
    model = make_continuous_generator(
        "lm", cfg=cfg, params=params, n_slots=4, chunk_size=4,
        kv_layout="paged", kv_block_len=8, kv_pool_blocks=2049,
        device="cuda", supervision={"backoff_base_s": 0.05,
                                    "max_failures": 5})
    sup = model.engine_supervisor
    prompt = np.arange(1, 20, dtype=np.int32)
    inj = faultinject.get_injector()
    try:
        baseline = list(model.engine.submit(prompt, 30))
        gc.collect()
        torch.cuda.synchronize()
        live = torch.cuda.memory_allocated()
        pool = model.engine.runtime_snapshot()["memory"]["kv_pool"]
        dead = model.engine
        inj.arm([{"point": "engine_loop", "after": 2, "times": 1}])
        with pytest.raises(ServerError) as ei:
            list(dead.submit(prompt, 30))
        inj.clear()
        assert ei.value.status == 503 and ei.value.retry_after == 0.05
        end = time.time() + 60
        while not (sup.healthy() and sup.restarts == 1):
            assert time.time() < end, "no restart"
            time.sleep(0.01)
        rebuilt = model.engine
        # the rebuilt engine builds its state and warm chunks on its own
        # thread as soon as it starts: count K2 once that is done
        while "ready" not in rebuilt._dev:
            assert time.time() < end, "the rebuilt engine never got ready"
            time.sleep(0.01)
        before, chunks0 = pa.launches, rebuilt.stats()["chunks_dispatched"]
        assert list(rebuilt.submit(prompt, 30)) == baseline
        chunks = rebuilt.stats()["chunks_dispatched"] - chunks0
        assert chunks > 0 and pa.launches - before == 2 * 4 * chunks
        gc.collect()
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
        assert dead._dev == {}
        assert abs(after - live) < pool // 2, (live, after, pool)
    finally:
        inj.clear()
        model.shutdown()


def test_a_sampled_dispatch_waits_on_its_own_cuda_event(card, monkeypatch):
    """The goodput plane's synchronous sample on the card: it waits for
    the work enqueued on the dispatching stream (a chain of bf16 matmuls,
    tens of ms) through a CUDA event recorded on that stream (here a side
    stream, the dispatching thread's current one), and never calls
    ``torch.cuda.synchronize()``, which would wait for every stream."""
    import time

    from client_tpu_torch.server.goodput import GoodputTracker

    a = torch.randn(8192, 8192, device=card, dtype=torch.bfloat16)

    def busy(n):
        x = a
        for _ in range(n):
            x = (x @ a) * 1e-3
        return x

    busy(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    busy(20)
    torch.cuda.synchronize()
    chain_s = time.perf_counter() - t0
    recorded = []
    record = torch.cuda.Event.record

    def spy(self, stream=None):
        recorded.append(stream)
        return record(self, stream)

    def refuse(*args, **kwargs):
        raise AssertionError("the sample called torch.cuda.synchronize()")

    monkeypatch.setattr(torch.cuda.Event, "record", spy)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    tracker = GoodputTracker(sample_every=1)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        t0 = time.perf_counter()
        out = busy(20)
        enqueued = time.perf_counter() - t0
        tracker.note_dispatch("chunk", outputs={"ring_cnt": out})
        waited = time.perf_counter() - t0
    assert side.query()
    snap = tracker.snapshot()
    assert tracker.event_blocks == 1 and snap["sampled_total"] == 1
    assert recorded == [side]
    assert enqueued < chain_s / 2 < waited
    assert snap["sampled_ewma_ns"]["chunk"] > (chain_s / 2 - enqueued) * 1e9


def test_goodput_on_the_card_registers_the_mfu_pair(card):
    """A small paged generator on the card sampling every 2nd dispatch:
    the tokens equal an unsampled engine's, every sample waited on a CUDA
    event, and ``/metrics`` carries the MFU pair with the card's peak."""
    from client_tpu_torch.models.decoder_lm import make_continuous_generator
    from client_tpu_torch.perf.bench_harness import card_peaks
    from client_tpu_torch.server import TorchInferenceServer
    from client_tpu_torch.server import metrics as tm

    cfg, params = _lane_model()
    prompt = np.arange(1, 20, dtype=np.int32)
    streams, engines = [], []
    core = TorchInferenceServer()
    for every in (0, 2):
        model = make_continuous_generator(
            f"lm{every}", cfg=cfg, params=params, n_slots=4, chunk_size=4,
            kv_layout="paged", kv_block_len=8, device="cuda",
            device_time_sample_every=every)
        core.register_model(model)
        streams.append(list(model.engine.submit(prompt, 30)))
        engines.append(model.engine)
    try:
        text = core.metrics_text()
    finally:
        core.stop()
    assert streams[0] == streams[1] and len(streams[0]) == 30
    snap = engines[1].goodput.snapshot()
    assert snap["sampled_total"] > 0
    assert engines[1].goodput.event_blocks == snap["sampled_total"]
    assert engines[0].goodput.snapshot()["sampled_total"] == 0
    peak = card_peaks(torch.cuda.get_device_name(0))[1]
    parsed = tm.parse_prometheus_text(text)
    for name in ("lm0", "lm2"):
        assert tm.sample_value(parsed, "client_tpu_goodput_device_peak_"
                               "flops", {"model": name}) == peak
        assert tm.sample_value(parsed, "client_tpu_goodput_mfu",
                               {"model": name}) > 0


# ---------------------------------------------------------------- training

def _train_pair(card, **extra):
    from client_tpu_torch.models import transformer as t

    cfg = t.TransformerConfig(vocab_size=64, d_model=32, n_layers=2,
                              n_heads=4, head_dim=8, d_ff=64, max_seq=32,
                              dtype=torch.float32, attn_impl="ref", **extra)
    params = t.init_params(torch.Generator().manual_seed(5), cfg)
    tokens = torch.randint(0, 64, (4, 17),
                           generator=torch.Generator().manual_seed(6))
    on_card = t._tree_map(lambda p: p.to(card), params)
    return t, cfg, params, on_card, tokens


@pytest.mark.parametrize("extra", [{}, {"n_experts": 4},
                                   {"n_experts": 4, "remat": True}])
def test_loss_and_gradients_on_the_card_match_the_cpu(card, extra):
    """value_and_grad of the dense, MoE and remat configs, f32 on the card
    against the CPU: the loss at rtol 1e-5, every gradient leaf at 1e-5
    (the CPU tests hold the CPU against jax.grad at the same bound)."""
    t, cfg, params, on_card, tokens = _train_pair(card, **extra)
    loss, grads = t.value_and_grad(cfg, params, tokens)
    cl, cg = t.value_and_grad(cfg, on_card, tokens.to(card))
    np.testing.assert_allclose(float(cl), float(loss), rtol=1e-5)
    for a, b in zip(t._tree_leaves(grads), t._tree_leaves(cg)):
        np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_a_train_step_refuses_flash_on_the_card(card):
    import dataclasses as dc

    t, cfg, _, _, _ = _train_pair(card)
    with pytest.raises(ValueError, match="no backward"):
        t.make_train_step(dc.replace(cfg, attn_impl="flash"))


@pytest.mark.parametrize("shape", [
    # S/dp, H/tp, Hkv/tp, Dh, block_len, N, table width: bench.py's
    # generation model (12 heads, MHA) at tp 2 and 4, at dp 1 and 2, and a
    # GQA model (32 heads, 8 KV heads, Dh 128) at tp 8: one KV head a rank
    (16, 6, 6, 64, 16, 193, 12), (16, 3, 3, 64, 16, 193, 12),
    (8, 3, 3, 64, 16, 193, 12), (8, 4, 1, 128, 16, 97, 12)],
    ids=["tp2", "tp4", "dp2_tp4", "gqa_tp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_at_tensor_parallel_local_heads(card, dtype, shape):
    """K2 at the heads one tp rank of a mesh holds (the sharded engine's
    ``paged_decode_steps``): the layer-major pool's slabs, against its
    plain version at the path's tolerance."""
    _k2_check(_paged_case(*shape, dtype=dtype, seed=sum(shape),
                          layout="layer_major"), dtype)


@pytest.mark.parametrize("kw", [dict(), dict(kv_layout="paged",
                                             prefix_cache=True)],
                         ids=["slot", "paged_prefix"])
def test_one_rank_nccl_mesh_engine_decodes_as_the_unsharded_one(card, kw):
    import torch_mesh_ranks

    from client_tpu_torch.parallel.collectives import run_ranks

    (plain, mesh), = run_ranks(torch_mesh_ranks.one_rank_mesh_engine, 1,
                               "nccl", 300, args=(kw,))
    assert mesh == plain


@pytest.mark.parametrize("plane", ["spec", "int8"])
@pytest.mark.parametrize("kw", [dict(), dict(kv_layout="paged",
                                             kv_block_len=8)],
                         ids=["slot", "paged"])
def test_one_rank_nccl_mesh_planes_decode_as_the_unsharded_one(card, kw,
                                                               plane):
    """Speculation (a self-draft) and int8 KV over a one-rank NCCL mesh at
    GQA widths: the streams of the unsharded engine, and verify rounds
    ran."""
    import torch_mesh_ranks

    from client_tpu_torch.parallel.collectives import run_ranks

    (plain, mesh), = run_ranks(torch_mesh_ranks.one_rank_mesh_planes, 1,
                               "nccl", 300, args=(kw, plane))
    assert mesh["streams"] == plain["streams"]
    if plane == "spec":
        assert mesh["rounds"] > 0 and mesh["rounds"] == plain["rounds"]


@pytest.mark.parametrize("size", [1, 16, 1 << 20])
@pytest.mark.parametrize("model", ["add_sub", "add_sub_fp32", "identity"])
def test_direct_cuda_library_bit_equal_to_the_cpu_library(card, model, size):
    """D1, the card's DIRECT library (libdirect_models_cuda.so: H2D, one
    hand-written kernel, D2H), gives the CPU library's outputs and plain
    torch's add, sub and copy on the card bit for bit on the same seeded
    inputs, and its launch counter counts the kernel's launches."""
    from client_tpu_torch import _native
    from client_tpu_torch._native.direct import DirectLibrary

    paths = _native.build(["libdirect_models_cpu.so",
                           "libdirect_models_cuda.so"])
    cpu = DirectLibrary(paths["libdirect_models_cpu.so"])
    gpu = DirectLibrary(paths["libdirect_models_cuda.so"])
    rng = np.random.default_rng(size)
    inputs = {}
    for i in range(1 if model == "identity" else 2):
        inputs[f"INPUT{i}"] = (
            rng.standard_normal(size).astype(np.float32)
            if model == "add_sub_fp32"
            else rng.integers(-2**31, 2**31, size, dtype=np.int64)
            .astype(np.int32))   # int32 add/sub wrap on both
    name = f"{model}:{size}"
    kernel = "copy" if model == "identity" else "add_sub"
    with cpu.model(name) as c, gpu.model(name) as g:
        want = c.infer(inputs)
        before = gpu.launches(kernel)
        got = [g.infer(inputs) for _ in range(3)]
        assert gpu.launches(kernel) == before + 3
        assert g.stats()["inference_stats"]["compute_infer"]["count"] == 3
    a = torch.from_numpy(inputs["INPUT0"]).cuda()
    if model == "identity":
        plain = {"OUTPUT0": a.clone()}
    else:
        b = torch.from_numpy(inputs["INPUT1"]).cuda()
        plain = {"OUTPUT0": a + b, "OUTPUT1": a - b}
    plain = {k: v.cpu().numpy() for k, v in plain.items()}
    assert set(plain) == set(want)
    for out in got:
        assert set(out) == set(want)
        for k in want:
            assert out[k].tobytes() == want[k].tobytes(), k
            assert out[k].tobytes() == plain[k].tobytes(), k


# ---------------------------------------------------------------- CUDA graphs
#
# The compile plane's executables (server/runtime_stats.py): a watched
# entry point captured as a CUDA graph at its first call per signature and
# replayed after it, with fresh inputs copied into its static buffers.

def _graphed(fn, positions):
    """``fn`` watched and captured, its arguments at ``positions`` fed per
    call, its outputs copied out of the graph's static buffers."""
    from client_tpu_torch.server.runtime_stats import (
        CompileWatch,
        capture_inputs,
        clone_outputs,
    )

    watch = CompileWatch("graphs")
    return watch, watch.watch("kernel", fn, capture=capture_inputs(
        fn, positions, "cuda", out=clone_outputs))


@pytest.mark.parametrize("shape", [(2, 128, 12, 64), (3, 100, 4, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_replayed_from_a_graph_is_bit_equal_to_eager(card, dtype, shape):
    """K1 captured at its first call and replayed with fresh q, k, v copied
    into the graph's static buffers: every replay bit-equal to an eager
    launch on the same inputs, and each replay counted as one launch (the
    capture itself launches nothing)."""
    watch, run = _graphed(fa.flash_attention, (0, 1, 2))
    first = [_randn(shape, dtype, 1) for _ in range(3)]
    before = fa.launches
    out0 = run(*first)               # eager warm-up + capture
    assert fa.launches - before == 1 and watch.captured() == 1
    assert torch.equal(out0, fa.flash_attention(*first))
    for seed in (2, 3, 4):
        qkv = [_randn(shape, dtype, seed * 10 + i) for i in range(3)]
        before = fa.launches
        got = run(*qkv)
        assert fa.launches - before == 1
        want = fa.flash_attention(*qkv)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    snap = watch.snapshot()
    assert snap["total_compiles"] == 1 and watch.captured() == 1


@pytest.mark.parametrize("shape", [(16, 12, 12, 64, 16, 193, 12),
                                   (5, 16, 4, 128, 16, 61, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_replayed_from_a_graph_is_bit_equal_to_eager(card, dtype, shape):
    """K2 captured and replayed with fresh queries, pools, tables and
    positions copied in: bit-equal to eager launches, one launch counted
    per replay."""
    watch, run = _graphed(pa.paged_decode_attention, (0, 1, 2, 3, 4))
    first = _paged_case(*shape, dtype=dtype, seed=1)
    before = pa.launches
    run(*first)
    assert pa.launches - before == 1
    for seed in (2, 3):
        args = _paged_case(*shape, dtype=dtype, seed=seed)
        before = pa.launches
        got = run(*args)
        assert pa.launches - before == 1
        want = pa.paged_decode_attention(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert watch.snapshot()["total_compiles"] == 1


def test_a_failed_capture_raises_and_never_runs_eagerly(card):
    """A function that reads a device value on the host cannot be
    captured: its first call raises, and so does every later call of the
    signature (no eager fallback)."""
    def syncs(x):
        return x * float(x.sum().item())

    watch, run = _graphed(syncs, (0,))
    x = torch.ones(4, device="cuda")
    with pytest.raises(Exception):
        run(x)
    with pytest.raises(RuntimeError, match="failed to capture"):
        run(x)
    assert watch.captured() == 0


@pytest.mark.parametrize("kw", [dict(), dict(kv_layout="paged",
                                             kv_block_len=8)],
                         ids=["slot", "paged"])
def test_graph_engine_streams_equal_the_eager_engine(card, kw):
    """A small engine with its chunk steps as CUDA graphs against the same
    engine built under ``capture_disabled()``: every greedy and sampled
    stream token-equal, the same K2 launches per chunk dispatch (counted
    from replays), graphs captured only by the graph engine, and no
    serving-phase compile in either."""
    from client_tpu_torch.perf.bench_harness import (
        ragged_generation_jobs,
        run_engine_jobs,
    )
    from client_tpu_torch.server.generation import ContinuousBatchingEngine
    from client_tpu_torch.server.runtime_stats import capture_disabled

    cfg, params = _lane_model()
    jobs = ragged_generation_jobs(6, 97, 6, (1, 30), (3, 20), 64)
    got = {}
    for arm in ("graphs", "eager"):
        def build():
            return ContinuousBatchingEngine(cfg, params, n_slots=4, chunk=4,
                                            device="cuda", **kw).start()

        if arm == "eager":
            with capture_disabled():
                eng = build()
        else:
            eng = build()
        try:
            list(eng.submit(np.zeros(3, np.int32), 2))   # engine ready
            chunks0, before = eng.stats()["chunks_dispatched"], pa.launches
            _, _, toks = run_engine_jobs(eng, jobs, collect=True,
                                         join_timeout_s=300)
            chunks = eng.stats()["chunks_dispatched"] - chunks0
            snap = eng.compile_watch.snapshot()
            got[arm] = (toks, pa.launches - before, chunks,
                        eng.compile_watch.captured(), snap)
        finally:
            eng.stop()
    (g_toks, g_k2, g_chunks, g_graphs, g_snap) = got["graphs"]
    (e_toks, e_k2, e_chunks, e_graphs, e_snap) = got["eager"]
    assert g_toks == e_toks
    paged = kw.get("kv_layout") == "paged"
    assert g_k2 == (2 * 4 * g_chunks if paged else 0)
    assert e_k2 == (2 * 4 * e_chunks if paged else 0)
    assert g_graphs == g_snap["total_compiles"] and e_graphs == 0
    for snap in (g_snap, e_snap):
        assert snap["sealed"] and snap["unexpected_compiles"] == 0


def test_graph_encoder_is_bit_equal_to_eager_and_copies_out(card):
    """A two-layer bf16 encoder TorchModel with K1 (one bucket of 4): the
    graph model's fused-split rows are bit-equal to the eager model's, and
    a batch's rows stay its own after the next replays (the copy-out)."""
    from client_tpu_torch.models.transformer import init_params
    from client_tpu_torch.perf.bench_harness import make_encoder_model
    from client_tpu_torch.server.runtime_stats import capture_disabled

    cfg = _encoder_cfg()
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    models = {}
    for arm in ("graphs", "eager"):
        def build():
            m = make_encoder_model(cfg, params, 32, 4, device="cuda")
            m.load()
            m.warmup()
            return m

        if arm == "eager":
            with capture_disabled():
                models[arm] = build()
        else:
            models[arm] = build()
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = [{"input_ids": torch.randint(0, 128, (1, 32), generator=gen,
                                        device="cuda", dtype=torch.int32)}
            for _ in range(7)]
    outs = {}
    for arm, m in models.items():
        first = m.execute_parts_fused_split(rows[:3], 4)[0]["embedding"]
        second = m.execute_parts_fused_split(rows[3:], 4)[0]["embedding"]
        outs[arm] = (first, second)
    torch.cuda.synchronize()
    for i in range(4):
        assert torch.equal(outs["graphs"][0][i], outs["eager"][0][i])
        assert torch.equal(outs["graphs"][1][i], outs["eager"][1][i])
    assert not torch.equal(outs["graphs"][0][0], outs["graphs"][1][0])
    snap = models["graphs"].compile_watch.snapshot()
    assert snap["sealed"] and snap["unexpected_compiles"] == 0
    assert snap["total_compiles"] == 3     # apply and both fused kinds
    # the two fused kinds replay one graph per bucket
    assert models["graphs"].compile_watch.captured() == 2
    assert models["eager"].compile_watch.captured() == 0


def test_graph_replays_from_three_threads_equal_eager(card):
    """Three dispatch threads of one graph TorchModel, whose graphs share
    one memory pool, replay at once: ``fused_batch_split`` at buckets 4
    and 8 and ``fused_batch`` at bucket 4 (the split kind's graph), with
    fresh rows every call. Every batch's rows are bit-equal to the eager
    model's on the same rows. A graph captured later may keep its static
    outputs where another keeps its intermediates, so a replay queued
    between another's replay and its copy-out would corrupt that batch."""
    import threading

    from client_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )
    from client_tpu_torch.perf.bench_harness import encoder_apply
    from client_tpu_torch.server.config import (
        DynamicBatchingConfig,
        ModelConfig,
        TensorSpec,
    )
    from client_tpu_torch.server.model import (
        TorchModel,
        finish_host_copies,
        start_host_copies,
    )
    from client_tpu_torch.server.runtime_stats import capture_disabled

    cfg = TransformerConfig(vocab_size=512, d_model=256, n_layers=4,
                            n_heads=4, head_dim=64, d_ff=1024, max_seq=128,
                            dtype=torch.bfloat16, attn_impl="flash",
                            causal=False)
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    mcfg = ModelConfig(
        name="threads", max_batch_size=8,
        inputs=(TensorSpec("input_ids", "INT32", (128,)),),
        outputs=(TensorSpec("embedding", "FP32", (256,)),),
        dynamic_batching=DynamicBatchingConfig(preferred_batch_size=(8,)),
        batch_buckets_override=(4, 8))
    models = {}
    for arm in ("graphs", "eager"):
        def build():
            m = TorchModel(mcfg, lambda p, x: encoder_apply(cfg, p, x),
                           params=params, device="cuda")
            m.load()
            m.warmup()
            return m

        if arm == "eager":
            with capture_disabled():
                models[arm] = build()
        else:
            models[arm] = build()
    gen = torch.Generator(device="cuda").manual_seed(7)
    pool = [{"input_ids": torch.randint(0, 512, (1, 128), generator=gen,
                                        device="cuda", dtype=torch.int32)}
            for _ in range(64)]
    graphs, n_calls = models["graphs"], 40
    plans = {"split4": (4, "split"), "split8": (8, "split"),
             "fused4": (4, "fused")}
    got = {name: [] for name in plans}
    errors = []
    barrier = threading.Barrier(len(plans))

    def dispatch(model, bucket, how, rows):
        if how == "split":
            split, event = model.execute_parts_fused_split(rows, bucket)
            event.synchronize()
            return torch.cat(split["embedding"], dim=0)
        return finish_host_copies(start_host_copies(
            model.execute_parts_fused(rows, bucket)))["embedding"]

    def worker(name, bucket, how):
        try:
            barrier.wait()
            for i in range(n_calls):
                start = (11 * i + bucket) % 56
                rows = pool[start:start + bucket]
                got[name].append((start, dispatch(graphs, bucket, how,
                                                  rows)))
        except Exception as exc:  # noqa: BLE001 — raised in the main thread
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(name, b, how))
               for name, (b, how) in plans.items()]
    for th in threads:
        th.start()
    for th in threads:
        th.join(120)
    assert not errors, errors
    for name, (bucket, how) in plans.items():
        assert len(got[name]) == n_calls
        for start, out in got[name]:
            want = dispatch(models["eager"], bucket, how,
                            pool[start:start + bucket])
            assert torch.equal(torch.as_tensor(out), torch.as_tensor(want)), (
                name, start)
    snap = graphs.compile_watch.snapshot()
    assert snap["sealed"] and snap["unexpected_compiles"] == 0
    assert graphs.compile_watch.captured() == 4   # apply and fused, x2


def _encoder_cfg():
    from client_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(vocab_size=128, d_model=64, n_layers=2,
                             n_heads=4, head_dim=16, d_ff=128, max_seq=32,
                             dtype=torch.bfloat16, attn_impl="flash",
                             causal=False)
