"""The host side of the cluster LSTM kernels (kernels 1-5),
without a card: the launch planner of ``eegflow_torch.nn.lstm_plan`` and the
weight layouts the wrappers build.

The fragment tests decode the layouts with the B-operand fragment of
``mma.sync.m16n8k16`` as the PTX ISA defines it (lane = 4 n + k-pair; b0, b1
at k = 2 k-pair + 0/1, b2, b3 eight rows further), independently of the
permutations that build them, and multiply in the order the kernels do."""

import numpy as np
import pytest
import torch

from eegflow_torch.nn import lstm_plan as lp

HIDDEN = list(range(32, 513, 32))


def _fixed(n):
    """A card that holds ``n`` clusters of any geometry."""
    return lambda rows, hc, k_res, smem, threads: n


@pytest.mark.parametrize("hidden", HIDDEN)
@pytest.mark.parametrize("kind", ["fwd", "bwd", "rec", "rec_bwd"])
def test_plan_geometry_fits_the_card(kind, hidden):
    p = lp.plan(kind, 64, hidden, _fixed(32))
    assert p.hc * p.units == hidden and p.units % 8 == 0 and 1 <= p.hc <= lp.MAX_CLUSTER
    assert p.threads <= (1024 if kind == "rec_bwd" else 512) and p.rows in (16, 32, 48)
    assert p.threads <= 256 or p.rows == 16
    assert p.smem == lp.smem_bytes(kind, hidden, p.units, p.rows, p.k_res) <= lp.SMEM_LIMIT
    assert p.resident or (p.k_res % lp.K_STEP == 0 and 0 <= p.k_res < lp.k_total(kind, hidden))
    if hidden in (64, 128, 256):  # what ModelConfig resolves to, and H=64: whole slice
        assert p.resident
    want = ({64: (2, 32), 128: (4, 32), 256: (8, 32)} if kind in ("rec", "rec_bwd")
            else {64: (1, 64), 128: (2, 64), 256: (4, 64)})
    assert (p.hc, p.units) == want.get(hidden, (p.hc, p.units))


@pytest.mark.parametrize("batch", [1, 5, 16, 17, 64, 512, 1000, 1024, 4096])
@pytest.mark.parametrize("kind,directions", [("fwd", 1), ("bwd", 1), ("bwd", 2), ("rec", 1),
                                             ("rec_bwd", 1)])
def test_plan_covers_every_row_once_within_the_active_clusters(kind, directions, batch):
    active = 30  # what an H100 SXM holds of these clusters of 4
    p = lp.plan(kind, batch, 256, _fixed(active), directions)
    covered = [r for tile in range(p.tiles) for r in p.rows_of(tile)]
    assert covered == list(range(batch))
    assert p.clusters == p.tiles * directions
    # every row count keeps the whole slice at H=256: the fewest waves win
    assert p.resident
    assert p.waves == -(-p.clusters // active) == min(
        -(-(-(-batch // rows) * directions) // active) for rows in lp.ROWS)
    if kind == "fwd" and batch in (512, 1024):  # the main path's shapes: one wave
        assert (p.rows, p.waves) == ((32, 1) if batch == 512 else (48, 1))


def test_plan_prefers_a_resident_slice_then_fewer_waves_then_fewer_rows():
    # H=384 forward: 16 rows keep the whole slice, 32 do not
    assert lp.resident_rows("fwd", 384, 64, 16) == 384 > lp.resident_rows("fwd", 384, 64, 32)
    p = lp.plan("fwd", 1024, 384, _fixed(20))
    assert (p.rows, p.resident, p.waves) == (16, True, 4)
    # kernel 4 at B=512: 48 rows give one wave; kernel 3: a tie, the fewer rows
    assert (lp.plan("bwd", 512, 256, _fixed(30), directions=2).rows,
            lp.plan("bwd", 512, 256, _fixed(30)).rows) == (48, 32)
    # H=512: no resident plan; the fewest waves, then the fewer rows
    p = lp.plan("fwd", 1024, 512, _fixed(16))
    assert not p.resident and (p.rows, p.waves) == (32, 2)


@pytest.mark.parametrize("hidden", [0, 16, 48, 100, 544, 1024])
def test_plan_rejects_hidden_outside_the_range(hidden):
    with pytest.raises(ValueError, match="H % 32"):
        lp.plan("fwd", 8, hidden, _fixed(32))


def test_plan_raises_when_no_cluster_fits():
    with pytest.raises(RuntimeError, match="fits on this card"):
        lp.plan("fwd", 8, 256, _fixed(0))
    seen = []
    lp.plan("bwd", 8, 512, lambda rows, hc, k_res, smem, threads: seen.append(smem) or 4)
    assert seen and max(seen) <= lp.SMEM_LIMIT  # over-large geometries are not queried


def _decode_fwd(frag, hidden):
    """W (H, 4H) in gate-interleaved column order, read from the forward
    fragments the way a warp's lanes hold them."""
    frag = frag.float().reshape(hidden // 8, hidden // 16, 2, 32, 2, 4).numpy()
    w = np.zeros((hidden, 4 * hidden), np.float32)  # columns: octet, gate, unit
    for o in range(hidden // 8):
        for kt in range(hidden // 16):
            for half in range(2):
                for lane in range(32):
                    n, kp = lane // 4, lane % 4
                    for gi in range(2):
                        b = frag[o, kt, half, lane, gi]
                        col = (o * 4 + 2 * half + gi) * 8 + n
                        k = kt * 16 + 2 * kp
                        w[[k, k + 1, k + 8, k + 9], col] = b
    return w


def _decode_bwd(frag, hidden):
    """W_hh^T (4H, H) read from the backward fragments as lanes hold them."""
    frag = frag.float().reshape(hidden // 8, hidden // 8, 32, 2, 4).numpy()
    wt = np.zeros((4 * hidden, hidden), np.float32)
    for o in range(hidden // 8):
        for kt2 in range(hidden // 8):
            for lane in range(32):
                n, kp = lane // 4, lane % 4
                for kk in range(2):
                    k = (2 * kt2 + kk) * 16 + 2 * kp
                    wt[[k, k + 1, k + 8, k + 9], o * 8 + n] = frag[o, kt2, lane, kk]
    return wt


@pytest.mark.parametrize("hidden", [32, 64, 96])
def test_fwd_fragments_round_trip_and_product(hidden):
    rng = np.random.default_rng(hidden)
    w = torch.from_numpy(rng.standard_normal((hidden, 4 * hidden)).astype(np.float32))
    frag = lp.fwd_fragments(w)
    assert frag.dtype == torch.bfloat16 and frag.numel() == w.numel()
    assert torch.equal(lp.fwd_unfragment(frag, hidden), w.to(torch.bfloat16))
    perm = lp.gate_interleave(hidden)
    assert sorted(perm.tolist()) == list(range(4 * hidden))
    w16 = w.to(torch.bfloat16).float()
    decoded = _decode_fwd(frag, hidden)
    assert np.array_equal(decoded, w16[:, perm].numpy())
    h = torch.from_numpy(rng.standard_normal((16, hidden)).astype(np.float32))
    h16 = h.to(torch.bfloat16).float()
    np.testing.assert_allclose(h16.numpy() @ decoded, (h16 @ w16)[:, perm].numpy(),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("hidden", [32, 64, 96])
def test_bwd_fragments_round_trip_and_product(hidden):
    rng = np.random.default_rng(100 + hidden)
    w = torch.from_numpy(rng.standard_normal((hidden, 4 * hidden)).astype(np.float32))
    frag = lp.bwd_fragments(w)
    assert frag.dtype == torch.bfloat16 and frag.numel() == w.numel()
    assert torch.equal(lp.bwd_unfragment(frag, hidden), w.to(torch.bfloat16))
    w16 = w.to(torch.bfloat16).float()
    decoded = _decode_bwd(frag, hidden)
    assert np.array_equal(decoded, w16.t().numpy())
    dz = torch.from_numpy(rng.standard_normal((16, 4 * hidden)).astype(np.float32))
    dz16 = dz.to(torch.bfloat16).float()
    np.testing.assert_allclose(dz16.numpy() @ decoded, (dz16 @ w16.t()).numpy(), rtol=1e-5,
                               atol=1e-4)


def test_a_cta_slice_is_contiguous_in_fragment_order():
    """A CTA copies its slice as one block per octet: octet o's fragments
    are row o of both layouts."""
    hidden = 64
    octet_of_col = (torch.arange(4 * hidden) % hidden) // 8
    f = lp.fwd_fragments(octet_of_col.float().expand(hidden, -1))
    b = lp.bwd_fragments((torch.arange(hidden) // 8).float()[:, None].expand(-1, 4 * hidden))
    for o in range(hidden // 8):
        assert (f[o].float() == o).all() and (b[o].float() == o).all()


@pytest.mark.parametrize("allowed", [(16,), (32,), (48,), (16, 48)])
def test_plan_takes_only_the_rows_it_is_allowed(allowed):
    # kernel 4 at B=512 on 30 clusters: the more rows, the fewer waves
    p = lp.plan("bwd", 512, 256, _fixed(30), directions=2, rows_allowed=allowed)
    assert p.rows == max(allowed) and p.resident


@pytest.mark.parametrize("rows", [(), (8,), (16, 64)])
def test_plan_rejects_rows_outside_the_kernels_tiles(rows):
    with pytest.raises(ValueError, match="subset"):
        lp.plan("fwd", 64, 256, _fixed(30), rows_allowed=rows)
    from eegflow_torch.nn import cuda_lstm

    with pytest.raises(ValueError, match="subset"):
        cuda_lstm.restrict_plan_rows(rows)
    assert cuda_lstm._plan_rows == lp.ROWS


@pytest.mark.parametrize("variant", ["base", "nomma", "noexch", "nostore", "noload", "noln",
                                     "nostream", "onetf32", "onedir", "stamps", "nodraw",
                                     "rk4loop", "rk4fdiv", "rk4fmax", "phases", "exactgelu",
                                     "gbload"])
def test_ablation_variants_patch_the_current_sources(variant, tmp_path):
    """Each text an ablation replaces occurs once in today's kernel sources,
    so the variant builds what its name says."""
    from eegflow_torch import kernels
    from eegflow_torch.kernels import ablate

    src = ablate.patched_sources(variant, tmp_path)
    changed = {p.name for p in src.iterdir()
               if p.read_bytes() != (kernels.CSRC / p.name).read_bytes()}
    assert changed == {name for name, _, _ in ablate.VARIANTS[variant]}
    for name, text, repl in ablate.VARIANTS[variant]:
        assert (kernels.CSRC / name).read_text().count(text) == 1
        assert repl in (src / name).read_text()


@pytest.mark.parametrize("hidden,hc", [(32, 1), (64, 2), (128, 4), (160, 5), (256, 8),
                                       (416, 4), (512, 8)])
def test_rec_clusters_aim_at_32_units_a_cta(hidden, hc):
    """Kernel 1 (float32): the largest divisor of H/8 up to ceil(H/32) and 8;
    the bf16 kinds keep theirs (ceil(H/64))."""
    assert lp.cluster_size(hidden, "rec") == hc
    assert lp.cluster_size(hidden) == lp.cluster_size(hidden, "bwd") == max(
        d for d in range(1, min(8, -(-hidden // 64)) + 1) if (hidden // 8) % d == 0)


def test_rec_shared_memory_and_resident_rows():
    """The float32 slice (H x 4U x 4 B) and two float32 h buffers of rows of
    H + 4: at H=256 the whole 128 KB slice stays beside 48 rows; at H=512 only
    its first k_res rows, a multiple of 64."""
    assert lp.slice_row_bytes("rec", 32) == 512
    assert lp.smem_bytes("rec", 256, 32, 48, 256) == 131_072 + 2 * 48 * 260 * 4 == 230_912
    assert lp.smem_bytes("rec", 256, 32, 32, 256) == 131_072 + 2 * 32 * 260 * 4
    for rows in lp.ROWS:
        assert lp.resident_rows("rec", 256, 32, rows) == 256
    assert [lp.resident_rows("rec", 512, 64, rows) for rows in lp.ROWS] == [128, 64, 0]
    assert lp.smem_bytes("rec", 512, 64, 16, 128) <= lp.SMEM_LIMIT
    assert lp.smem_bytes("rec", 512, 64, 16, 192) > lp.SMEM_LIMIT
    with pytest.raises(ValueError, match="kind"):
        lp.smem_bytes("f32", 256, 32, 16, 0)


@pytest.mark.parametrize("batch,active,rows,waves", [
    (512, 16, 32, 1),    # 16 clusters of 32 rows in one wave
    (512, 11, 48, 1),    # only 48 rows fit one wave
    (512, 10, 32, 2),    # two waves either way: the fewer rows
    (1024, 16, 32, 2),   # float32 eval at the serving bucket: two waves
    (1024, 22, 48, 1),
    (64, 16, 16, 1)])
def test_rec_plan_picks_rows_by_waves(batch, active, rows, waves):
    p = lp.plan("rec", batch, 256, _fixed(active))
    assert (p.hc, p.units, p.threads, p.resident) == (8, 32, 128, True)
    assert (p.rows, p.waves) == (rows, waves)


def test_rec_plan_streams_the_slice_at_512():
    """H=512: 8 CTAs of 64 units; no row count keeps the 512 KB slice, so the
    plan takes the fewest waves, then the fewer rows."""
    p = lp.plan("rec", 512, 512, _fixed(16))
    assert (p.hc, p.units, p.resident) == (8, 64, False)
    assert (p.rows, p.k_res, p.waves) == (32, 64, 1)


@pytest.mark.parametrize("hidden,hc", [(32, 1), (64, 2), (160, 5), (256, 8), (416, 4)])
def test_rec_slices_round_trip_and_product(hidden, hc):
    """CTA c's slice holds W_hh[k, gate H + c U + u] at [c, k, u, gate], so one
    16-byte load gives a thread its unit's four gates at one k; its product
    with h in the kernel's order (k ascending) is h . W_hh."""
    rng = np.random.default_rng(200 + hidden)
    w = torch.from_numpy(rng.standard_normal((hidden, 4 * hidden)).astype(np.float32))
    sl = lp.rec_slices(w, hc)
    units = hidden // hc
    assert sl.dtype == torch.float32 and tuple(sl.shape) == (hc, hidden, units, 4)
    assert torch.equal(lp.rec_unslice(sl), w)
    c, k, u, gate = hc - 1, hidden - 3, units - 1, 2
    assert sl[c, k, u, gate] == w[k, gate * hidden + c * units + u]
    h = torch.from_numpy(rng.standard_normal((3, hidden)).astype(np.float32))
    z = torch.zeros(3, hc, units, 4)
    for kk in range(hidden):
        z += h[:, kk, None, None, None] * sl[:, kk]
    want = (h.double() @ w.double()).reshape(3, 4, hc, units).permute(0, 2, 3, 1)
    np.testing.assert_allclose(z.numpy(), want.float().numpy(), rtol=1e-4, atol=1e-4)


def test_rec_slices_reject_a_split_off_octets():
    with pytest.raises(ValueError, match="octets"):
        lp.rec_slices(torch.zeros(64, 256), 3)


def test_kernel_plans_query_each_kernel_on_its_kind(monkeypatch):
    """kernel_plan asks each recurrent kernel's own query for its clusters
    (kernel 3b's chain has its own registers), on the planner kind of its
    weight slice: kernel 3b plans as kernel 3, kernel 1 as "rec", kernel 5
    as "rec_bwd"."""
    from eegflow_torch.nn import cuda_lstm

    asked = []

    def fake(kernel, mode, hidden, rows, hc, k_res, smem):
        asked.append((kernel, mode, rows, hc))
        return 30 if kernel != "rec" else 16

    monkeypatch.setattr(cuda_lstm, "_query_clusters", fake)
    monkeypatch.setattr(cuda_lstm, "_plans", {})
    assert set(cuda_lstm._PLAN_QUERIES) == set(cuda_lstm._PLAN_KINDS)
    v2 = cuda_lstm.kernel_plan("bwd_v2", 512, 256)
    k3 = cuda_lstm.kernel_plan("bwd", 512, 256)
    assert v2.kind == k3.kind == "bwd" and (v2.hc, v2.rows, v2.k_res, v2.smem) == (
        k3.hc, k3.rows, k3.k_res, k3.smem)
    rec = cuda_lstm.kernel_plan("rec", 512, 256, 1)
    assert (rec.kind, rec.hc, rec.rows, rec.waves) == ("rec", 8, 32, 1)
    k5 = cuda_lstm.kernel_plan("rec_bwd", 512, 256)
    assert (k5.kind, k5.hc, k5.units, k5.threads) == ("rec_bwd", 8, 32, 256)
    assert {a[0] for a in asked} == {"bwd_v2", "bwd", "rec", "rec_bwd"}
    assert all(mode == 1 for kernel, mode, _, hc in asked if kernel == "rec")
    with pytest.raises(ValueError, match="kernel must be one of"):
        cuda_lstm.kernel_plan("bwd_raw", 512, 256)


def test_raw_gate_chain_shares_the_patched_loader():
    """Kernel 3b instantiates the chain of lstm_bwd_chain.cuh with its raw-gate
    step, so the ablations' texts there patch kernels 3, 3b and 4 alike."""
    from eegflow_torch import kernels

    v2 = (kernels.CSRC / "lstm_bwd_v2.cu").read_text()
    chain = (kernels.CSRC / "lstm_bwd_chain.cuh").read_text()
    assert "chain_direction<kMT, true>" in v2 and '#include "gemm.cuh"' not in v2
    for name in ("lstm_bwd.cu", "lstm_bwd_dualdir.cu"):
        assert "chain_direction<kMT, true>" not in (kernels.CSRC / name).read_text()
    assert chain.count("auto load_planes = [&](int t)") == 1
    # one load statement, through ldcs_pair (float32 or bf16 residuals), the
    # only streaming loads of the chain
    assert chain.count("v = planar ? ldcs_pair(") == 1
    assert chain.count("__ldcs(") == 2


def test_load_library_keeps_one_build_per_process(tmp_path, monkeypatch):
    """A second build of the library in one process faults: once a library
    is loaded, naming other sources raises."""
    from eegflow_torch import kernels

    monkeypatch.setattr(kernels, "_lib", object())
    monkeypatch.setattr(kernels, "_lib_csrc", kernels.CSRC.resolve())
    assert kernels.load_library() is kernels._lib
    assert kernels.load_library(kernels.CSRC) is kernels._lib
    with pytest.raises(RuntimeError, match="built from"):
        kernels.load_library(tmp_path)


@pytest.mark.parametrize("hidden,hc", [(32, 1), (64, 2), (160, 5), (256, 8), (416, 4)])
def test_rec_bwd_slices_round_trip_and_product(hidden, hc):
    """Kernel 5's slice of CTA c holds W_hh[k, gate H + c U + u] at
    [c, u, gate, k], k contiguous; each CTA's product of its own dz columns
    with it, n = (u, gate) ascending, summed over the CTAs in rank order, is
    dz . W_hh^T."""
    rng = np.random.default_rng(300 + hidden)
    w = torch.from_numpy(rng.standard_normal((hidden, 4 * hidden)).astype(np.float32))
    sl = lp.rec_bwd_slices(w, hc)
    units = hidden // hc
    assert sl.dtype == torch.float32 and tuple(sl.shape) == (hc, units, 4, hidden)
    assert sl.is_contiguous() and torch.equal(lp.rec_bwd_unslice(sl), w)
    c, u, gate, k = hc - 1, units - 1, 2, hidden - 3
    assert sl[c, u, gate, k] == w[k, gate * hidden + c * units + u]
    dz = torch.from_numpy(rng.standard_normal((3, 4 * hidden)).astype(np.float32))
    dh = torch.zeros(3, hidden)
    for cta in range(hc):
        own = dz.reshape(3, 4, hc, units)[:, :, cta].permute(0, 2, 1)  # (row, u, gate)
        part = torch.zeros(3, hidden)
        for uu in range(units):
            for g in range(4):
                part += own[:, uu, g, None] * sl[cta, uu, g]
        dh += part
    want = dz.double() @ w.double().t()
    np.testing.assert_allclose(dh.numpy(), want.float().numpy(), rtol=1e-4, atol=1e-3)
    with pytest.raises(ValueError, match="octets"):
        lp.rec_bwd_slices(torch.zeros(64, 256), 3)


@pytest.mark.parametrize("hidden", [64, 128, 160, 256, 416])
def test_rec_bwd_plan_takes_kernel_1s_clusters(hidden):
    """Kernel 5 runs on kernel 1's geometry (the same CTAs and units, with
    twice the threads: two halves split the rows and the product); its CTA
    holds the 4U x H slice, the dz tile (rows x 4U) and one partial inbox
    (hc x rows x U), float32. At B=512 on a card of 15 such clusters,
    H <= 256 keeps the whole slice beside 48 rows in one wave; H=416 (CTAs
    of 26 warps) takes 16 rows and streams all but 64 slice rows."""
    p = lp.plan("rec_bwd", 512, hidden, _fixed(15))
    r = lp.plan("rec", 512, hidden, _fixed(15))
    assert (p.hc, p.units, p.threads) == (r.hc, r.units, 2 * r.threads)
    k = 4 * p.units
    assert lp.k_total("rec_bwd", hidden) == k
    assert p.smem == p.k_res * hidden * 4 + p.rows * (k + hidden) * 4 <= lp.SMEM_LIMIT
    if hidden <= 256:
        assert (p.rows, p.k_res, p.waves) == (48, k, 1)
    else:
        assert (p.rows, p.k_res) == (16, 64) and not p.resident
    assert lp.smem_bytes("rec_bwd", 256, 32, 48, 128) == 131_072 + 24_576 + 49_152
    with pytest.raises(ValueError, match="hidden"):
        lp.slice_row_bytes("rec_bwd", 32)
