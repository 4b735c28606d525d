"""The port's CUDA kernels against their plain versions, the
serving engine on the card against ``graph.run``, and the fused
emitter's C body against ``eval_netlist``.  The interpreter's C++ core
is checked on the CPU in ``test_torch_interp.py``.

The ``gpu`` tests need a card and skip without one (each test decides,
through the ``cuda`` fixture); run them on the card with
``pytest -m gpu tests/test_torch_cuda.py``.  The emitter test compiles
the generated body — plain ``uint32_t`` C — with the host ``g++`` and
runs here on the CPU.
"""
import ctypes
import dataclasses
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch import _build
from repro_torch.core.codegen import eval_netlist
from repro_torch.core.fpformat import (HOBFLOPS_FORMATS, RNE, RTZ, FPFormat,
                                       StorageFormat)
from repro_torch.core.fused_backend import kernel as fused
from repro_torch.kernels.bitslice_mac import kernel as interp
from repro_torch.kernels.conv2d_bitslice.network import NetworkGraph
from repro_torch.kernels.dequant_matmul import kernel as dqk
from repro_torch.kernels.dequant_matmul import ops as dq
from repro_torch.kernels.dequant_matmul.ref import dequant_matmul_ref
from repro_torch.quant.storage import QuantizedTensor, dequantize, quantize

F8 = HOBFLOPS_FORMATS["hobflops8"]
F9 = HOBFLOPS_FORMATS["hobflops9"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _operands(rng, fmt, P, C, Mw):
    i_masks = -rng.integers(0, 2, (P, C, fmt.nbits)).astype(np.int32)
    w_planes = rng.integers(-2**31, 2**31, (C, fmt.nbits, Mw),
                            dtype=np.int64).astype(np.int32)
    return torch.from_numpy(i_masks), torch.from_numpy(w_planes)


# Odd shapes (ragged P / Mw / C edges against every block) and block
# settings, including one thread per block and a C tile that is not a
# multiple of the chain depth.
CASES = [
    (F9, RNE, False, 37, 19, 3, {}),
    (F9, RNE, False, 5, 70, 17, {"p_block": 1, "m_block": 1,
                                 "c_block": 1, "c_unroll": 1}),
    (F8, RTZ, False, 50, 33, 2, {"p_block": 8, "m_block": 4,
                                 "c_block": 7, "c_unroll": 3}),
    (F8, RNE, True, 9, 12, 5, {"p_block": 2, "m_block": 32,
                               "c_block": 64, "c_unroll": 2}),
]


@pytest.mark.gpu
@pytest.mark.parametrize("fmt,rounding,extended,P,C,Mw,blocks", CASES)
@pytest.mark.parametrize("kernel", ["bitslice_mac", "fused_mac"])
def test_kernel_matches_plain_version(cuda, kernel, fmt, rounding,
                                      extended, P, C, Mw, blocks):
    rng = np.random.default_rng(P * 1000 + C)
    i_masks, w_planes = _operands(rng, fmt, P, C, Mw)
    kw = dict(fmt=fmt, extended=extended, rounding=rounding, **blocks)
    if kernel == "bitslice_mac":
        want = interp.bitslice_mac_cuda(i_masks, w_planes, **kw)
        got = interp.bitslice_mac_cuda(i_masks.to(cuda), w_planes.to(cuda),
                                       **kw)
    else:
        kw["relu"] = True
        want = fused.fused_mac_cuda(i_masks, w_planes, **kw)
        got = fused.fused_mac_cuda(i_masks.to(cuda), w_planes.to(cuda),
                                   **kw)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_kernels_block_independent(cuda):
    rng = np.random.default_rng(7)
    i_masks, w_planes = _operands(rng, F9, 29, 45, 6)
    i_masks, w_planes = i_masks.to(cuda), w_planes.to(cuda)
    outs = []
    for blocks in ({}, {"p_block": 1, "m_block": 6, "c_block": 45},
                   {"p_block": 16, "m_block": 2, "c_block": 5},
                   {"p_block": 3, "m_block": 32, "c_block": 40},
                   {"p_block": 2, "m_block": 16, "c_block": 8},
                   {"p_block": 4, "m_block": 8, "c_block": 7},
                   {"p_block": 1, "m_block": 6, "c_block": 64}):
        for k in (1, 4):
            kw = dict(fmt=F9, c_unroll=k, **blocks)
            outs.append(interp.bitslice_mac_cuda(i_masks, w_planes, **kw))
            outs.append(fused.fused_mac_cuda(i_masks, w_planes, **kw))
    torch.cuda.synchronize()
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


@pytest.mark.gpu
def test_interpreter_hobflops16_extended(cuda):
    """The widest format with the extended accumulator (e5m21), chain
    depth 4 and a ragged C against the plain version."""
    fmt = FPFormat(5, 10)
    rng = np.random.default_rng(16)
    i_masks, w_planes = _operands(rng, fmt, 35, 22, 2)
    kw = dict(fmt=fmt, extended=True, c_unroll=4)
    want = interp.bitslice_mac_cuda(i_masks, w_planes, **kw)
    got = interp.bitslice_mac_cuda(i_masks.to(cuda), w_planes.to(cuda), **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_interpreter_one_build_for_every_netlist(cuda):
    """Several formats, depths, roundings and both accumulators in one
    process run through one ``bitslice_mac`` library, built once: the
    programs are data, not code."""
    rng = np.random.default_rng(8)
    for fmt, k, rounding, extended in ((F8, 1, RNE, False),
                                       (F9, 4, RTZ, False),
                                       (F9, 3, RNE, True),
                                       (FPFormat(5, 10), 2, RNE, False)):
        i_masks, w_planes = _operands(rng, fmt, 9, 7, 1)
        kw = dict(fmt=fmt, c_unroll=k, rounding=rounding, extended=extended)
        got = interp.bitslice_mac_cuda(i_masks.to(cuda), w_planes.to(cuda),
                                       **kw)
        assert torch.equal(got.cpu(),
                           interp.bitslice_mac_cuda(i_masks, w_planes, **kw))
    libs = [lib for lib in _build._LOADED.values()
            if lib.name.startswith("bitslice_mac")]
    assert len(libs) == 1 and libs[0].name == "bitslice_mac"
    assert interp._BOUND["launch"] is not None


@pytest.mark.gpu
def test_interpreter_program_too_large_raises_before_launch(cuda):
    """A chain program larger than a block's shared memory (hobflops16,
    extended accumulator, 24 steps a chain) raises before any launch;
    it is never truncated."""
    fmt = FPFormat(5, 10)
    i_masks, w_planes = _operands(np.random.default_rng(0), fmt, 4, 24, 1)
    n0 = interp.bitslice_mac_cuda.launches
    with pytest.raises(ValueError, match="B of programs"):
        interp.bitslice_mac_cuda(i_masks.to(cuda), w_planes.to(cuda),
                                 fmt=fmt, extended=True, c_unroll=24)
    assert interp.bitslice_mac_cuda.launches == n0
    progs = interp.device_programs(fmt, 24, True, RNE, "avx512", "cuda")
    assert progs.program_bytes + 4 * progs.add.nrows * 32 > _build.MAX_SMEM


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1, 5, 13, 45])
@pytest.mark.parametrize("c_unroll", [1, 4])
def test_fused_ring_edges(cuda, C, c_unroll):
    """The fused kernel's ring at one channel, fewer channels than a ring
    slot, and a C that is not a multiple of the slot or the chain depth,
    against its plain version."""
    rng = np.random.default_rng(C)
    i_masks, w_planes = _operands(rng, F9, 23, C, 3)
    kw = dict(fmt=F9, relu=True, c_unroll=c_unroll)
    want = fused.fused_mac_cuda(i_masks, w_planes, **kw)
    got = fused.fused_mac_cuda(i_masks.to(cuda), w_planes.to(cuda), **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["cuda", "cuda_fused"])
def test_network_on_card_matches_cpu(cuda, backend):
    rng = np.random.default_rng(3)
    img = rng.standard_normal((2, 6, 6, 5)).astype(np.float32)

    def graph(device):
        g = NetworkGraph(F8, backend=backend, device=device)
        k = np.random.default_rng(4)
        c1 = g.conv("c1", g.input_name,
                    (k.standard_normal((3, 3, 5, 40)) * 0.3)
                    .astype(np.float32), relu=True)
        p1 = g.maxpool2d("p1", c1)
        d = g.conv("d", p1, (k.standard_normal((3, 3, 40, 8)) * 0.3)
                   .astype(np.float32), FPFormat(5, 5), stride=2)
        return g.output(g.avgpool2d("head", d, window=2))

    got = graph(cuda).run(img).cpu()
    want = graph("cpu").run(img)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
def test_plain_backend_refuses_card(cuda):
    i_masks, w_planes = _operands(np.random.default_rng(0), F8, 4, 4, 1)
    from repro_torch.kernels.bitslice_mac.ops import mac_planes
    with pytest.raises(ValueError):
        mac_planes(i_masks.to(cuda), w_planes.to(cuda), fmt=F8,
                   backend="torch")


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["cuda", "cuda_fused"])
def test_serve_conv_on_card_matches_graph_run(cuda, backend):
    """A mixed queue (singles and mini-batches of 2 and 4, one injected
    transient wave error, a ragged final wave) served on the card: each
    response equals ``graph.run`` on that request alone, bit for bit,
    and every conv of every wave launched its kernel once."""
    from repro_torch.serve_conv import (ConvRequest, ConvServeEngine,
                                        FaultInjector, FaultPlan,
                                        ServePolicy)
    rng = np.random.default_rng(5)
    g = NetworkGraph(F9, backend=backend, device=cuda)
    c1 = g.conv("c1", g.input_name, (rng.standard_normal((3, 3, 8, 40))
                                     * 0.3).astype(np.float32), relu=True)
    c2 = g.conv("c2", c1, (rng.standard_normal((1, 1, 40, 40)) * 0.3)
                .astype(np.float32), relu=True)
    g.output(g.maxpool2d("head", c2, window=2))
    hwc = (6, 6, 8)
    faults = FaultInjector(FaultPlan(wave_errors=1))
    eng = ConvServeEngine(g, hwc, max_batch=8, faults=faults,
                          policy=ServePolicy(retry_backoff_s=1e-4))
    assert eng.device.type == "cuda" and eng.max_batch == 8
    reqs = [ConvRequest(i, rng.standard_normal(
        hwc if n == 1 else (n,) + hwc).astype(np.float32))
        for i, n in enumerate((1, 2, 1, 4, 2, 1, 1, 4, 2))]
    for r in reqs[:4]:                       # tensors on the card too
        r.image = torch.from_numpy(r.image).to(cuda)
    for r in reqs:
        eng.submit(r)
    counter = (fused.fused_mac_cuda if backend == "cuda_fused"
               else interp.bitslice_mac_cuda)
    before = counter.launches
    done = eng.run()
    assert [r.rid for r in done] == list(range(len(reqs)))
    assert counter.launches - before == 2 * eng.waves
    assert faults.injected_wave_errors == 1 and done[0].attempts == 2
    for r in done:
        img = torch.as_tensor(r.image, device=cuda)
        solo = g.run(img[None] if img.ndim == 3 else img).cpu()
        solo = solo[0] if img.ndim == 3 else solo
        assert torch.equal(torch.from_numpy(r.out).view(torch.int32),
                           solo.view(torch.int32)), r.rid


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["cuda", "cuda_fused"])
def test_tune_conv_blocks_on_card(cuda, backend):
    """The default sweep launches on the card, and a graph pinned to its
    winner computes what the default launch computes, bit for bit."""
    from repro_torch.kernels.conv2d_bitslice.ops import (
        default_tune_candidates, tune_conv_blocks)
    rng = np.random.default_rng(6)
    img = rng.standard_normal((2, 6, 6, 8)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 8, 40)) * 0.3).astype(np.float32)
    best, results = tune_conv_blocks(img, k, fmt=F9, backend=backend,
                                     device=cuda, iters=1, relu=True)
    assert best in default_tune_candidates(backend)
    assert len(results) == len(default_tune_candidates(backend))
    outs = []
    for blocks in (None, best):
        g = NetworkGraph(F9, backend=backend, device=cuda)
        g.output(g.conv("c", g.input_name, k, relu=True, blocks=blocks))
        outs.append(g.run(img).cpu())
    assert torch.equal(outs[0].view(torch.int32), outs[1].view(torch.int32))


# ---------------------------------------------------------------------------
# The dequant matmul kernel
# ---------------------------------------------------------------------------
def _packed(rng, K, N, sfmt, scale=None):
    """A ``bitplane2d`` tensor of seeded weights.  The w_e = 8 format gets
    a given scale: its default one is subnormal and flushes to 0, which
    makes every weight NaN (as in the reference)."""
    w = torch.from_numpy((rng.standard_normal((K, N)) * 0.2)
                         .astype(np.float32))
    qt = quantize(w, sfmt, layout="bitplane", scale=scale)
    return QuantizedTensor(qt.data.reshape(sfmt.nbits, K, N // 32),
                           qt.scale, sfmt, "bitplane2d", (K, N))


def _on(qt, device):
    return QuantizedTensor(qt.data.to(device), qt.scale.to(device), qt.sfmt,
                           qt.layout, qt.shape)


def _within_sum_bound(got, want, x, w):
    """The float32 summation bound of a K-term dot product, elementwise:
    |got - want| <= 2 K 2**-24 (|x| @ |w|)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    bound = 2 * x.shape[1] * 2.0 ** -24 * (x.abs() @ w.abs())
    return bool(((got - want).abs() <= bound).all())


def _tf32_round(x):
    """float32 rounded to TF32's 10 fraction bits, ties away from zero
    (``cvt.rna.tf32.f32``)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


# The tensor-core route's largest error against the plain version, in
# units of the summation bound, is at most this share of a single-TF32
# product's (``chip_smoke.DQ_SPLIT_MARGIN``).
DQ_SPLIT_MARGIN = 0.1


DQ_FORMATS = [(StorageFormat(5, 2), None), (StorageFormat(5, 3), None),
              (StorageFormat(4, 3), None), (StorageFormat(8, 7), 2.0 ** -100)]


@pytest.mark.gpu
@pytest.mark.parametrize("sfmt,scale", DQ_FORMATS)
@pytest.mark.parametrize("M,K,N", [(37, 75, 96), (3, 130, 160),
                                   (129, 33, 32), (1, 896, 224)])
def test_dequant_matmul_matches_plain_version(cuda, sfmt, scale, M, K, N):
    """Ragged M, K and N = 32 x odd against the plain version on the card
    and on the CPU."""
    rng = np.random.default_rng(M * 1000 + K)
    qt = _packed(rng, K, N, sfmt, scale)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    qg, xg = _on(qt, cuda), x.to(cuda)
    got = dq.dequant_matmul(xg, qg)
    want = dequant_matmul_ref(xg, qg.data, qg.scale, sfmt, N)
    torch.cuda.synchronize()
    assert got.shape == (M, N) and bool(torch.isfinite(got).all())
    assert _within_sum_bound(got, want, xg, dequantize(qg))
    cpu = dq.dequant_matmul(x, qt)
    assert _within_sum_bound(got.cpu(), cpu, x, dequantize(qt))


@pytest.mark.gpu
def test_dequant_matmul_tiles_agree_and_count(cuda):
    """Each output is summed in an order that depends on K alone, so the
    rows of a launch over many rows (TILE_M64: blocks walk K) and of
    launches over a few rows (TILE_M8 up to SMALL_M rows: K split over
    blocks) give the same bits; every launch adds one to the count."""
    rng = np.random.default_rng(5)
    qt = _on(_packed(rng, 200, 352, StorageFormat(5, 3)), cuda)
    x = torch.from_numpy(rng.standard_normal((600, 200))
                         .astype(np.float32)).to(cuda)
    rows = (5, dqk.SMALL_M, dqk.SMALL_M + 1)
    assert dqk.tile_for(600) == dqk.TILE_M64
    assert [dqk.tile_for(m) for m in rows] == [dqk.TILE_M8, dqk.TILE_M8,
                                               dqk.TILE_M64]
    n0 = dq.dequant_matmul_cuda.launches
    full = dq.dequant_matmul(x, qt)
    outs = {m: dq.dequant_matmul(x[:m], qt) for m in rows}
    torch.cuda.synchronize()
    assert dq.dequant_matmul_cuda.launches == n0 + 1 + len(rows)
    for m, out in outs.items():
        assert torch.equal(out.view(torch.int32),
                           full[:m].view(torch.int32)), m


# (M, K, format) -> the route, n width, K chunks and split; a format
# whose codes do not fit TF32 (w_f > 10) takes the FMA route.
ROUTES = [
    (1, 896, StorageFormat(5, 3), "tensor_core", 8, 4, True),
    (4, 4864, StorageFormat(5, 3), "tensor_core", 8, 19, True),
    (9, 512, StorageFormat(8, 7), "tensor_core", 16, 2, True),
    (33, 513, StorageFormat(4, 3), "tensor_core", 64, 3, True),
    (64, 75, StorageFormat(5, 10), "tensor_core", 64, 1, True),
    (256, 896, StorageFormat(5, 3), "tensor_core", 64, 4, True),
    (257, 896, StorageFormat(5, 3), "tensor_core", 64, 4, False),
    (512, 4864, StorageFormat(5, 2), "tensor_core", 64, 19, False),
    (4, 896, StorageFormat(4, 11), "fma", None, None, None),
    (512, 896, StorageFormat(4, 11), "fma", None, None, None),
]


@pytest.mark.parametrize("M,K,sfmt,route,width,chunks,split", ROUTES)
def test_dequant_matmul_routing(M, K, sfmt, route, width, chunks, split):
    p = dqk.plan(M, K, sfmt)
    assert p["route"] == route
    if route == "fma":
        assert p == {"route": "fma"}
    else:
        assert p == {"route": route, "n_width": width, "chunks": chunks,
                     "split": split}
        assert width >= min(M, dqk.N_WIDTHS[-1]) and chunks * dqk.KCHUNK >= K
        assert split == (dqk.tile_for(M) == dqk.TILE_M8)


@pytest.mark.gpu
@pytest.mark.parametrize("sfmt,M,K,N", [
    (StorageFormat(5, 3), 4, 200, 96),      # K below one chunk
    (StorageFormat(5, 3), 7, 1100, 160),    # K not a multiple of the chunk
    (StorageFormat(5, 3), 300, 1100, 224),  # the same, blocks walking K
    (StorageFormat(5, 10), 17, 640, 64),    # the widest TF32 fraction
    (StorageFormat(4, 11), 5, 600, 96),     # w_f > 10: the FMA route
    (StorageFormat(4, 11), 80, 600, 96),
])
def test_dequant_matmul_chunks_and_routes(cuda, sfmt, M, K, N):
    """Against the plain version within the summation bound; on the
    tensor-core route also at most ``DQ_SPLIT_MARGIN`` of the error of a
    single-TF32 product (x rounded to TF32), so x's low half counts.  A
    call counts one launch and the CUDA kernels it launched."""
    rng = np.random.default_rng(M * 7 + K)
    qt = _on(_packed(rng, K, N, sfmt), cuda)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)) \
        .to(cuda)
    n0 = dq.dequant_matmul_cuda.launches
    k0 = dq.dequant_matmul_cuda.kernel_launches
    got = dq.dequant_matmul(x, qt)
    want = dequant_matmul_ref(x, qt.data, qt.scale, sfmt, N)
    torch.cuda.synchronize()
    p = dqk.plan(M, K, sfmt)
    kernels = 1 if p["route"] == "fma" else \
        2 + (p["split"] and p["chunks"] > 1)
    assert dq.dequant_matmul_cuda.launches == n0 + 1
    assert dq.dequant_matmul_cuda.kernel_launches == k0 + kernels
    assert got.shape == (M, N) and bool(torch.isfinite(got).all())
    w = dequantize(qt)
    assert _within_sum_bound(got, want, x, w)
    if p["route"] == "tensor_core":
        bound = (2 * K * 2.0 ** -24 * (x.abs() @ w.abs())).clamp(min=1e-30)
        ctrl = dequant_matmul_ref(_tf32_round(x), qt.data, qt.scale, sfmt, N)
        ratio = float(((got - want).abs() / bound).max())
        ctrl_ratio = float(((ctrl - want).abs() / bound).max())
        assert ratio <= DQ_SPLIT_MARGIN * ctrl_ratio, (ratio, ctrl_ratio)


@pytest.mark.gpu
def test_dequant_matmul_plain_backend_refuses_card(cuda):
    qt = _on(_packed(np.random.default_rng(0), 8, 32, StorageFormat(5, 3)),
             cuda)
    with pytest.raises(ValueError, match="CPU tensors only"):
        dq.dequant_matmul(torch.ones(2, 8, device=cuda), qt, backend="torch")


def test_launch_blocks_are_checked_before_launch():
    """A block the card would refuse (too many threads, too much shared
    memory, an empty block) raises in Python; the C tile rounds up to
    the chain depth."""
    assert _build.c_tile(32, 4) == 32 and _build.c_tile(7, 3) == 9
    assert _build.c_tile(1, 4) == 4
    _build.check_blocks(4, 16, 32, 48 * 1024)
    for p, m, smem in ((33, 32, 0), (0, 16, 0), (4, 16, 232449)):
        with pytest.raises(ValueError, match="blocks p="):
            _build.check_blocks(p, m, 32, smem)
    # The interpreter: barriers, both programs, the LUT3 mask table, two
    # raw C tiles, a 3-slot product ring and a file of rows for each
    # chain warp and producer warp, a row one word a chain (chains padded
    # to whole warps of 64 / gs, gs lanes a pair of chains).
    progs = interp.device_programs(F9, 4, False, RNE, "avx512", "cpu")
    nin, nout = F9.nbits, F9.mult_out().nbits
    add, mul = progs.add, progs.mul
    assert progs.program_bytes == 4 * (16 * (add.groups + 1)
                                       + 16 * (mul.groups + 1) + 2 * 12)
    assert interp.smem_bytes(progs, nin, 4, 16, 8, 2, 8) == \
        48 + progs.program_bytes + 256 * 32 + 4 * 2 * 20 * (8 * nin + 1) \
        + 4 * 3 * 8 * nout * 64 + 4 * add.nrows * 64 \
        + 4 * 2 * mul.nrows * 64
    assert interp.padded_chains(3, 7, 8) == 24
    assert interp.padded_chains(3, 7, 2) == 32
    # Eight lanes a pair of chains unless the block would pass 1024
    # threads.
    assert interp.block_threads(4, 16, 2, 8) == 768
    assert [interp.lanes_a_pair(p, m, pw) for p, m, pw in
            ((2, 8, 1), (4, 16, 4), (3, 32, 1), (16, 32, 1))] == [8, 4, 8, 2]
    with pytest.raises(ValueError, match="blocks p="):
        _build.check_blocks(33, 32, 8, 0,
                            threads=interp.block_threads(33, 32, 1, 1))
    # A ring slot shrinks by chain steps until the block fits.
    assert interp.ring_slot(progs, nin, 2, 16, 7, 4, 1, 8) == 8
    progs2 = interp.device_programs(F9, 2, False, RNE, "avx512", "cpu")
    slot = interp.ring_slot(progs2, nin, 2, 32, 64, 2, 1, 8)
    assert slot % 2 == 0 and slot < 64
    assert interp.smem_bytes(progs2, nin, 2, 32, slot, 1, 8) <= \
        _build.MAX_SMEM < interp.smem_bytes(progs2, nin, 2, 32, slot + 2, 1,
                                            8)
    # The fused ring: 3 barrier pairs, 2 slots of staged words and 3 of
    # product planes (64 chain lanes).
    assert fused.smem_bytes(11, 12, 4, 16, 32) == \
        48 + 4 * (2 * 20 * (32 * 11 + 1) + 3 * 64 * (32 * 12 + 1))
    # One chain warp and FUSED_PRODUCERS producer warps a chain warp; a
    # ring slot shrinks by chain steps until the block fits.
    per = 1 + _build.FUSED_PRODUCERS
    assert fused.block_threads(4, 16) == 64 * per
    assert fused.block_threads(3, 7) == 32 * per
    with pytest.raises(ValueError, match="blocks p="):
        _build.check_blocks(9, 32, 8, 0, threads=fused.block_threads(9, 32))
    assert fused.ring_slot(7, 3, 11, 12, 4, 16) == 9
    slot = fused.ring_slot(64, 2, 11, 12, 2, 32)
    assert slot % 2 == 0 and slot < 64
    assert fused.smem_bytes(11, 12, 2, 32, slot) <= _build.MAX_SMEM < \
        fused.smem_bytes(11, 12, 2, 32, slot + 2)


# ---------------------------------------------------------------------------
# The emitted fused body, compiled with the host C++ compiler
# ---------------------------------------------------------------------------
def test_emitted_body_matches_eval_netlist(tmp_path):
    """The MAC chain, the multiplier and the add-only chain, emitted as C
    (every gate an ``HF_LOP3`` truth table, here its C fallback), built
    with g++ and run against ``eval_netlist``."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    bodies = []
    for fmt in (F8, F9):
        for k in (1, 4):
            bodies.append(("mac", fmt, k,
                           fused.fused_chain_lowered(fmt, k, False, RNE)))
            bodies.append(("add", fmt, k,
                           fused.fused_add_lowered(fmt, k, False, RNE)))
        bodies.append(("mul", fmt, 1, fused.fused_mul_lowered(fmt, False,
                                                             RNE)))
    src = ["#include <cstdint>", "#define HF_INLINE inline"]
    for i, (kind, fmt, k, lowered) in enumerate(bodies):
        src.append(lowered.cuda_body(f"Body{i}", SIGN_OFF=0))
        if kind == "add":
            call = (f"Body{i}::run(x + i * Body{i}::K * Body{i}::NIN, "
                    f"acc + i * Body{i}::NOUT)")
        else:
            call = (f"Body{i}::run(x + i * Body{i}::K * Body{i}::NIN, "
                    f"y + i * Body{i}::K * Body{i}::NIN, "
                    f"acc + i * Body{i}::NOUT)")
        src.append(f'extern "C" void run{i}(const uint32_t* x, '
                   f"const uint32_t* y, uint32_t* acc, int n) {{ "
                   f"for (int i = 0; i < n; ++i) {call}; }}")
    cpp, so = tmp_path / "bodies.cpp", tmp_path / "bodies.so"
    cpp.write_text("\n".join(src) + "\n")
    subprocess.run([gxx, "-O1", "-shared", "-fPIC", "-o", str(so),
                    str(cpp)], check=True)
    lib = ctypes.CDLL(str(so))
    rng = np.random.default_rng(11)
    n = 256

    def words(*shape):
        return rng.integers(0, 2**32, shape, dtype=np.uint64) \
            .astype(np.uint32)

    for i, (kind, fmt, k, lowered) in enumerate(bodies):
        nin, nout = fmt.nbits, fmt.mult_out().nbits
        width = nout if kind == "add" else nin
        xs, ys, acc = words(k, width, n), words(k, width, n), words(nout, n)
        inputs = {} if kind == "mul" else {"acc": acc}
        for j in range(k):
            if kind == "add":
                inputs[f"p{j}"] = xs[j]
            else:
                inputs[f"x{j}"], inputs[f"y{j}"] = xs[j], ys[j]
        want = eval_netlist(lowered.graph, inputs)["out"]
        x = np.ascontiguousarray(xs.transpose(2, 0, 1))
        y = np.ascontiguousarray(ys.transpose(2, 0, 1))
        a = np.ascontiguousarray(acc.T)
        getattr(lib, f"run{i}")(*(ctypes.c_void_p(t.ctypes.data)
                                  for t in (x, y, a)), ctypes.c_int(n))
        assert (a.T == want).all(), (kind, fmt, k)


# ---------------------------------------------------------------------------
# Blockwise attention (csrc/flash_attention.cu) against its plain version
# ---------------------------------------------------------------------------
# (B, Sq, Sk, Hkv, G, D, dtype, causal, q_offset): several tiles both ways,
# a ragged last tile (Sq, Sk no multiple of the kernel's 64 or 32 nor of
# the plain version's blocks), every head size, Sq != Sk; cases 8-10
# hold more than 32 query tiles a kv head, so dK/dV splits them.  From
# case 11 on, bf16 (the tensor-core route) at every head size, causal
# and not, with a q_offset, G = 7 rows crossing 64-row tiles, Sq != Sk
# both ways, and k/v narrower (Hkv D) than a 64-column TMA box.
FLASH_CASES = [
    (2, 64, 64, 2, 2, 16, torch.float32, True, 0),
    (2, 64, 64, 2, 2, 16, torch.float32, False, 0),
    (1, 100, 77, 2, 3, 32, torch.float32, False, 0),
    (1, 100, 130, 1, 3, 64, torch.float32, True, 30),
    (2, 130, 130, 2, 7, 64, torch.bfloat16, True, 0),
    (1, 70, 70, 2, 2, 128, torch.float32, True, 0),
    (1, 70, 90, 1, 2, 256, torch.float32, True, 5),
    (1, 33, 33, 1, 1, 256, torch.bfloat16, False, 0),
    (2, 300, 300, 2, 7, 64, torch.float32, True, 0),
    (1, 600, 600, 1, 4, 32, torch.bfloat16, True, 3),
    (1, 520, 300, 2, 4, 128, torch.float32, False, 0),
    (2, 64, 64, 2, 2, 16, torch.bfloat16, True, 0),
    (1, 64, 90, 1, 1, 16, torch.bfloat16, False, 0),
    (1, 100, 77, 2, 3, 32, torch.bfloat16, False, 0),
    (1, 100, 130, 1, 3, 64, torch.bfloat16, True, 30),
    (2, 300, 300, 2, 7, 64, torch.bfloat16, True, 0),
    (1, 70, 70, 2, 2, 128, torch.bfloat16, True, 0),
    (1, 520, 300, 2, 4, 128, torch.bfloat16, False, 0),
    (1, 70, 90, 1, 2, 256, torch.bfloat16, True, 5),
    (1, 300, 520, 1, 2, 256, torch.bfloat16, True, 0),
    (1, 2200, 2200, 1, 1, 64, torch.bfloat16, True, 0),
]
# As a share of the plain version's largest magnitude: f32 the same
# float32 operations in another order (measured on an H100: o 5e-7,
# gradients 4e-6); bf16 one bf16 rounding of the largest value (2^-7).
FLASH_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2 ** -7, 2 ** -7)}
# bf16 outputs whose bits differ from the plain version's, at most this
# share of each (chip_smoke.FLASH_BITS_OFF: the products are exact, the
# f32 sums differ in order and in wgmma's accumulation; measured on an
# H100 at most 0.7% here, and 40-43% with one bf16 term a split product
# at 4096 tokens).
FLASH_BITS_OFF = 0.1


def _flash_operands(case, dev):
    B, Sq, Sk, Hkv, G, D, dt, causal, off = case
    g = torch.Generator().manual_seed(Sq * 1000 + Sk + D)
    mk = lambda *s: torch.randn(*s, generator=g).to(dt).to(dev)
    return (mk(B, Sq, Hkv, G, D), mk(B, Sk, Hkv, D), mk(B, Sk, Hkv, D),
            mk(B, Sq, Hkv, G, D), dict(causal=causal, q_block=64,
                                       kv_block=32, q_offset=off))


def _share(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max())


def _bits_off(a, b):
    """The share of a's elements whose bits differ from b's."""
    return float((a.view(torch.int16) != b.view(torch.int16)).float().mean())


@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_kernels_match_plain_version(cuda, case):
    """Forward (o, lse) and backward (dq, dk, dv) kernels against the
    plain versions on the same CUDA tensors (bf16 outputs also by the
    share of elements not bit-equal); each wrapper counts its call."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention.ref import (flash_bwd_ref,
                                                         flash_fwd_ref)
    q, k, v, do, kw = _flash_operands(case, cuda)
    n_fwd, n_bwd = fa.flash_fwd_cuda.launches, fa.flash_bwd_cuda.launches
    o, lse = fa.flash_fwd_cuda(q, k, v, **kw)
    grads = fa.flash_bwd_cuda(do, q, k, v, o, lse, **kw)
    torch.cuda.synchronize()
    assert fa.flash_fwd_cuda.launches == n_fwd + 1
    assert fa.flash_bwd_cuda.launches == n_bwd + 1
    ro, rl = flash_fwd_ref(q, k, v, **kw)
    want = flash_bwd_ref(do, q, k, v, ro, rl, **kw)
    t_o, t_g = FLASH_TOL[q.dtype]
    assert o.dtype == q.dtype and _share(o, ro) <= t_o
    assert _share(lse, rl) <= 1e-6
    for name, a, b in zip("qkv", grads, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert _share(a, b) <= t_g, (name, _share(a, b))
    if q.dtype == torch.bfloat16:
        off = {n: _bits_off(a, b)
               for n, a, b in zip(("o", "dq", "dk", "dv"), (o, *grads),
                                  (ro, *want))}
        print(f"{case}: elements not bit-equal {off}")
        assert max(off.values()) <= FLASH_BITS_OFF, off


@pytest.mark.gpu
def test_flash_backward_is_deterministic_and_op_reaches_kernels(cuda):
    """Two backward calls give the same bits (no atomics), and the
    model's ``_flash`` under autograd launches the forward and backward
    kernels through ``repro_torch::flash_fwd``/``flash_bwd``."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.models.attention import _flash
    q, k, v, do, kw = _flash_operands(FLASH_CASES[9], cuda)
    o, lse = fa.flash_fwd_cuda(q, k, v, **kw)
    a = fa.flash_bwd_cuda(do, q, k, v, o, lse, **kw)
    b = fa.flash_bwd_cuda(do, q, k, v, o, lse, **kw)
    for x, y in zip(a, b):
        assert (x.view(torch.uint8) == y.view(torch.uint8)).all()
    B, Sq, Hkv, G, D = q.shape
    qh = q.reshape(B, Sq, Hkv * G, D).clone().requires_grad_()
    kh, vh = k.clone().requires_grad_(), v.clone().requires_grad_()
    n_fwd, n_bwd = fa.flash_fwd_cuda.launches, fa.flash_bwd_cuda.launches
    out = _flash(qh, kh, vh, causal=True, q_block=512, kv_block=512)
    out.float().sum().backward()
    torch.cuda.synchronize()
    assert fa.flash_fwd_cuda.launches == n_fwd + 1
    assert fa.flash_bwd_cuda.launches == n_bwd + 1
    assert bool(torch.isfinite(qh.grad.float()).all())


@pytest.mark.gpu
def test_flash_repeats_bit_for_bit_on_both_routes(cuda):
    """On either route (bf16 operands: tensor cores; float32: FFMA) two
    calls of the forward and of the backward give the same bits."""
    from repro_torch.kernels.flash_attention import kernel as fa
    for case in (FLASH_CASES[15], FLASH_CASES[8]):
        q, k, v, do, kw = _flash_operands(case, cuda)
        o, lse = fa.flash_fwd_cuda(q, k, v, **kw)
        a = fa.flash_bwd_cuda(do, q, k, v, o, lse, **kw)
        o2, lse2 = fa.flash_fwd_cuda(q, k, v, **kw)
        b = fa.flash_bwd_cuda(do, q, k, v, o, lse, **kw)
        for x, y in zip((o, lse, *a), (o2, lse2, *b)):
            assert (x.view(torch.uint8) == y.view(torch.uint8)).all()


# ---------------------------------------------------------------------------
# LM training on the card (the blockwise attention kernels are on this path)
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "olmoe-1b-7b"])
def test_train_step_on_card(cuda, arch):
    """One smoke-twin train step on the card (bf16 compute, two
    micro-batches): finite loss, gradient norm and parameters; and, at
    float32 compute, the remat'd gradients equal the kept-activation
    ones within ``1e-4 * max|leaf|``.  The backward of a gather (the
    embedding's, MoE's dispatch and combine) adds with atomics on the
    card, in any order: in bf16 one run's MoE gradients differ from the
    next run's by ~1e-2 of a leaf's largest value with or without remat
    (``scripts/torch_train_remat_probe.py`` on an H100, olmoe's twin:
    7.5e-3 remat against remat, 8.5e-3 remat against none; 4.4e-7 and
    4.4e-7 at float32)."""
    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import dataset_for, make_batch, place_batch
    from repro_torch.models import lm_loss
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.schema import _leaves, _unflatten
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainConfig, init_state, make_train_step
    cfg = smoke_config(arch)
    tc = TrainConfig(opt=OptConfig(lr=1e-2, warmup_steps=2), n_micro=2)
    state = init_state(cfg, tc, torch.Generator(device=cuda).manual_seed(0),
                       cuda)
    batch = place_batch(make_batch(dataset_for(
        cfg, ShapeConfig("t", 64, 4, "train")), 0), cuda)
    params = state["params"]
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    grads = {}
    for remat in (True, False):
        leaves = [p.detach().requires_grad_() for p in _leaves(params)]
        loss, _ = lm_loss(_unflatten(params, leaves), batch, f32,
                          remat=remat)
        grads[remat] = torch.autograd.grad(loss, leaves)
    for a, b in zip(grads[True], grads[False]):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    _, metrics = make_train_step(cfg, tc)(state, batch)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert float(metrics["grad_norm"]) > 0 and int(state["step"]) == 1
    assert all(bool(torch.isfinite(p).all()) for p in _leaves(params))


# ---------------------------------------------------------------------------
# Distribution on the card (the blockwise attention kernels are on the
# mesh train step's path)
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_compress_grads_on_card_matches_cpu(cuda):
    """int8 error-feedback compression without a generator: the same
    float32 operations on the card and on the CPU, bit for bit, over 5
    rounds."""
    from repro_torch.distributed.compression import (compress_grads,
                                                     make_error_feedback)
    g = torch.Generator().manual_seed(0)
    grads = [{"w": torch.randn(257, 96, generator=g) * 1e-2,
              "b": torch.randn(96, generator=g)} for _ in range(5)]
    ef = {d: make_error_feedback(grads[0]) for d in ("cpu", "cuda")}
    for gr in grads:
        out_cpu, ef["cpu"] = compress_grads(gr, ef["cpu"])
        out_dev, ef["cuda"] = compress_grads(
            {k: v.to(cuda) for k, v in gr.items()},
            {k: v.to(cuda) for k, v in ef["cuda"].items()})
        for k in gr:
            for a, b in ((out_dev[k], out_cpu[k]), (ef["cuda"][k],
                                                    ef["cpu"][k])):
                assert (a.cpu().view(torch.int32)
                        == b.view(torch.int32)).all(), k


@pytest.mark.gpu
def test_mesh_train_loop_on_card(cuda):
    """A one-card NCCL mesh (``host_mesh``): two float32 smoke-twin steps
    through ``train_loop(mesh=)`` give the ``device=`` run's losses
    within 1e-5 relative (the embedding's backward adds with atomics),
    and ``compressed_psum`` over the one-rank group equals
    ``dequantize_int8(*quantize_int8(x))`` bit for bit.  The group is
    destroyed at the end."""
    import torch.distributed as dist

    from repro_torch.configs import smoke_config
    from repro_torch.distributed.compression import (compressed_psum,
                                                     dequantize_int8,
                                                     quantize_int8)
    from repro_torch.launch.mesh import host_mesh
    from repro_torch.launch.train import train_loop
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainConfig
    cfg = dataclasses.replace(smoke_config("qwen2-0.5b"),
                              compute_dtype="float32")
    shape = ShapeConfig("t", 64, 4, "train")
    tc = TrainConfig(opt=OptConfig(warmup_steps=2, total_steps=4),
                     n_micro=2)
    quiet = dict(steps=2, tc=tc, print_fn=lambda m: None)
    _, want = train_loop(cfg, shape, device=cuda, **quiet)
    mesh = host_mesh("cuda")
    try:
        _, got = train_loop(cfg, shape, mesh=mesh, **quiet)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
        x = torch.randn(1000, 33, device=cuda)
        psum = compressed_psum(x, mesh.get_group("data"))
        ref = dequantize_int8(*quantize_int8(x))
        assert (psum.view(torch.int32) == ref.view(torch.int32)).all()
    finally:
        dist.destroy_process_group()
