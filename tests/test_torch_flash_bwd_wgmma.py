"""The arithmetic and schedule of the bf16 ``flash_attention`` backward, on the CPU.

The kernels (``src/repro_torch/kernels/csrc/flash_attention_bwd_tc.cu``) run
on Hopper with wgmma and TMA. The dK/dV kernel takes blocks of KEYS keys of
one (batch, kv head), each consumer warpgroup 64 of them (at D = 240 both
share one block of 64, split by output), and walks the q tiles of BQ rows of
each q head of the group whose rows see some key of the block; a warpgroup
runs the products of a tile only where its keys are seen, masking only the
tiles that cross its diagonal, its window edge or the end of the keys or
rows. Its products are transposed: S^T = K Q^T and dP^T = V dO^T, whose
rows are keys and columns q rows, so P^T and dS^T come out of the
accumulators as the A operands of dV += P^T dO and dK += dS^T Q. The dQ
kernel takes blocks of 128 q rows, 64 a warpgroup, over the key tiles of
BKV keys the rows may see. P and dS are formed in f32 with L in log2 units
and the scale folded into one FMA, and rounded to bf16 before their
products; dS is formed from P before rounding. Blocks are handed out key
blocks first to last (dK/dV) and q blocks last to first (dQ).

Here that schedule is walked tile by tile in numpy, with every tile constant
read from the ``.cu`` source, so the walk cannot drift from the kernel's
tiling. The same numpy-seeded q, k, v and dO go through the walk, through the
port's plain backward (``ref.flash_attention_bwd``) and through ``jax.vjp``
of the JAX package's ``repro.models.attention._sdpa`` (where no row is fully
masked: the reference masks with -1e30, as ``tests/test_torch_flash_bwd.py``
says): within 2e-2 of each gradient's max |value| with P and dS rounded to
bf16, the limit the CUDA tests hold the kernel to, and within 1e-5 of it in
f32 with nothing rounded, which checks the tile schedule and the masks apart
from the rounding. Products of the tensor cores are summed in float64 and
rounded to f32 once per product, as their f32 accumulation allows.
"""
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import ref

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
          / "flash_attention_bwd_tc.cu").read_text()
LOG2E = 1.4426950408889634
WG = 64          # keys or q rows of one consumer warpgroup


def _constexpr(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


CONSUMERS = _constexpr("CONSUMERS")
DQ_ROWS = WG * CONSUMERS
DKDV = {int(d): (int(keys), int(bq), int(st)) for d, keys, bq, st in re.findall(
    r"struct DkdvTiling<(\d+)> \{ static constexpr int KEYS = (\d+), BQ = (\d+), "
    r"STAGES = (\d+); \};", SOURCE)}
DQ = {int(d): (int(bkv), int(st)) for d, bkv, st in re.findall(
    r"struct DqTiling<(\d+)> \{ static constexpr int BKV = (\d+), STAGES = (\d+); \};", SOURCE)}


def _split(d):
    """Whether the dK/dV consumers split by output (one block of 64 keys)."""
    return d > 128


def test_source_constants():
    """The tiling the walk reads is the kernel's: two consumer warpgroups,
    one entry per head dim of the wrapper, 64 keys a warpgroup (or 64 shared
    where the consumers split by output), tiles of whole k-steps of 16."""
    assert CONSUMERS == 2 and "constexpr int DQ_ROWS = 64 * CONSUMERS;" in SOURCE
    assert "static constexpr bool SPLIT = D > 128;" in SOURCE
    assert sorted(DKDV) == sorted(DQ) == sorted(kflash.HEAD_DIMS)
    for d, (keys, bq, stages) in DKDV.items():
        assert keys == (WG if _split(d) else WG * CONSUMERS) and bq % 16 == 0 and stages >= 2
    assert all(bkv % 16 == 0 and stages >= 2 for bkv, stages in DQ.values())


# -- the kernels' index arithmetic, line for line -------------------------------

def rows_seeing(k_first, k_last, sq, skv, window):
    """[i_lo, i_hi]: the rows that see some key of [k_first, k_last]."""
    off = skv - sq
    i_lo = max(0, k_first - off)
    i_hi = min(sq - 1, k_last + window - 1 - off) if window else sq - 1
    return i_lo, i_hi


def kv_block_at(x, kv_heads, sq, skv, window, d):
    """(kv_head, k0, qt0, n_qt) of dK/dV block x."""
    keys, bq, _ = DKDV[d]
    kv_head, k0 = x % kv_heads, x // kv_heads * keys
    i_lo, i_hi = rows_seeing(k0, min(k0 + keys, skv) - 1, sq, skv, window)
    qt0 = i_lo // bq
    return kv_head, k0, qt0, (i_hi // bq - qt0 + 1 if i_hi >= i_lo else 0)


def kv_tiles_seen(qt0, n_qt, kw, sq, skv, window, d):
    """[j_lo, j_hi): the q tiles of each head seen by the keys [kw, kw + 64)."""
    bq = DKDV[d][1]
    if kw >= skv or n_qt == 0:
        return 0, 0
    i_lo, i_hi = rows_seeing(kw, min(kw + WG - 1, skv - 1), sq, skv, window)
    if i_lo > i_hi:
        return 0, 0
    return i_lo // bq - qt0, i_hi // bq - qt0 + 1


def kv_edge(kw, q0, sq, skv, window, bq):
    off = skv - sq
    return (kw + WG - 1 > q0 + off or kw + WG > skv or q0 + bq > sq
            or (bool(window) and kw <= q0 + bq - 1 + off - window))


def q_block_at(x, bhs, sq, skv, window, d):
    """(bh, q0, kb0, n_tiles) of dQ block x."""
    bkv = DQ[d][0]
    nqb = -(-sq // DQ_ROWS)
    bh, q0 = x % bhs, (nqb - 1 - x // bhs) * DQ_ROWS
    off = skv - sq
    k_hi = min(skv, min(q0 + DQ_ROWS, sq) + off) - 1
    k_lo = max(0, q0 + off - window + 1) if window else 0
    kb0 = k_lo // bkv * bkv
    return bh, q0, kb0, ((k_hi - kb0) // bkv + 1 if k_hi >= kb0 else 0)


def dq_tiles_seen(r0, sq, skv, window, bkv, kb0, n_tiles):
    """[j_lo, j_hi): the tiles of the block the rows [r0, r0 + 64) may see."""
    if r0 >= sq or n_tiles <= 0:
        return 0, 0
    qpos0 = r0 + skv - sq
    k_last, k_first = qpos0 + WG - 1, (qpos0 - window + 1 if window else 0)
    j_hi = min(n_tiles, (k_last - kb0) // bkv + 1) if k_last >= kb0 else 0
    j_lo = (k_first - kb0) // bkv if k_first > kb0 else 0
    return (0, 0) if j_lo >= j_hi else (j_lo, j_hi)


def dq_edge(kb, qpos0, skv, window, bkv):
    return (kb + bkv - 1 > qpos0 or kb + bkv > skv
            or (bool(window) and kb <= qpos0 + WG - 1 - window))


def dkdv_tiles(b, hq, hkv, sq, skv, d, window):
    """The dK/dV kernel's products in grid order: (block, kv head, keys kw of
    a warpgroup, q head, first row q0, masked), for each tile it runs."""
    keys, bq, _ = DKDV[d]
    group, kv_heads = hq // hkv, b * hkv
    for x in range(kv_heads * -(-skv // keys)):
        kv_head, k0, qt0, n_qt = kv_block_at(x, kv_heads, sq, skv, window, d)
        bb, h = divmod(kv_head, hkv)
        for kw in ([k0] if _split(d) else range(k0, k0 + keys, WG)):
            j_lo, j_hi = kv_tiles_seen(qt0, n_qt, kw, sq, skv, window, d)
            for hg in range(group):
                for qt in range(j_lo, j_hi):
                    q0 = (qt0 + qt) * bq
                    yield x, kv_head, kw, bb * hq + h * group + hg, q0, kv_edge(
                        kw, q0, sq, skv, window, bq)


def dq_tiles(b, hq, sq, skv, d, window):
    """The dQ kernel's products in grid order: (block, head, first row r0 of a
    warpgroup, first key kb, masked), for each tile it runs."""
    bkv, bhs = DQ[d][0], b * hq
    for x in range(bhs * -(-sq // DQ_ROWS)):
        bh, q0, kb0, n_tiles = q_block_at(x, bhs, sq, skv, window, d)
        for r0 in range(q0, q0 + DQ_ROWS, WG):
            j_lo, j_hi = dq_tiles_seen(r0, sq, skv, window, bkv, kb0, n_tiles)
            for j in range(j_lo, j_hi):
                kb = kb0 + j * bkv
                yield x, bh, r0, kb, dq_edge(kb, r0 + skv - sq, skv, window, bkv)


def _visible(sq, skv, window):
    qpos = np.arange(sq)[:, None] + skv - sq
    kpos = np.arange(skv)[None, :]
    keep = kpos <= qpos
    if window:
        keep &= kpos > qpos - window
    return keep


# -- the walk ------------------------------------------------------------------

def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).bfloat16().float().numpy()


def _f32(x):
    return np.asarray(x, dtype=np.float64).astype(np.float32)


def _rows(x, r0, n):
    """Rows [r0, r0 + n) of x [S, D] as a TMA box loads them: zeros past S."""
    out = np.zeros((n, x.shape[1]), np.float32)
    m = max(0, min(n, x.shape[0] - r0))
    out[:m] = x[r0:r0 + m]
    return out


def kernel_bwd(q, k, v, o, do, lse, *, window=None, round_bf16=True):
    """(dq, dk, dv) as the three launches compute them, f32 (the kernel then
    rounds each to bf16), from f32 arrays q, o, do [B, Hq, Sq, D], k, v
    [B, Hkv, Skv, D] and lse [B, Hq, Sq]."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    scale = np.float32(1.0 / math.sqrt(d))
    sl2 = np.float32(scale * np.float32(LOG2E))
    rnd = _bf16 if round_bf16 else (lambda x: x)  # noqa: E731
    # The D pass, and L in log2 units; rows past Sq load as L = D = 0.
    delta = _f32((do.astype(np.float64) * o).sum(-1))
    l2 = _f32(lse.astype(np.float64) * np.float32(LOG2E))
    qf, dof = q.reshape(b * hq, sq, d), do.reshape(b * hq, sq, d)
    kf, vf = k.reshape(b * hkv, skv, d), v.reshape(b * hkv, skv, d)
    l2f, deltaf = l2.reshape(b * hq, sq), delta.reshape(b * hq, sq)
    vis = _visible(sq, skv, window)
    pad = lambda x, r0, n: np.pad(x, (0, n))[r0:r0 + n]  # noqa: E731

    def p_ds(s, dp, lrow, drow, keep, edge):
        with np.errstate(over="ignore", invalid="ignore"):
            p = np.exp2(_f32(s.astype(np.float64) * sl2 - lrow)).astype(np.float32)
            ds = _f32(p.astype(np.float64) * _f32(dp.astype(np.float64) - drow))
        if edge:
            p, ds = np.where(keep, p, np.float32(0)), np.where(keep, ds, np.float32(0))
        else:                      # an interior tile: every pair is visible
            assert keep.all()
        return rnd(p), rnd(ds)

    keys, bq, _ = DKDV[d]
    dk, dv = np.zeros_like(kf), np.zeros_like(vf)
    acc = {}
    for _, kv_head, kw, bh, q0, edge in dkdv_tiles(b, hq, hkv, sq, skv, d, window):
        kt, vt = _rows(kf[kv_head], kw, WG), _rows(vf[kv_head], kw, WG)
        qt, dot = _rows(qf[bh], q0, bq), _rows(dof[bh], q0, bq)
        st = _f32(kt.astype(np.float64) @ qt.T)            # S^T = K Q^T
        dpt = _f32(vt.astype(np.float64) @ dot.T)          # dP^T = V dO^T
        key, row = kw + np.arange(WG)[:, None], q0 + np.arange(bq)[None, :]
        keep = (row < sq) & (key < skv)
        keep &= vis[np.minimum(row, sq - 1), np.minimum(key, skv - 1)]
        pt, dst = p_ds(st, dpt, pad(l2f[bh], q0, bq)[None], pad(deltaf[bh], q0, bq)[None], keep,
                       edge)
        ak, av = acc.get((kv_head, kw), (np.zeros((WG, d), np.float32),) * 2)
        acc[kv_head, kw] = (_f32(ak + dst.astype(np.float64) @ qt),
                            _f32(av + pt.astype(np.float64) @ dot))
    for (kv_head, kw), (ak, av) in acc.items():
        n = min(WG, skv - kw)
        dk[kv_head, kw:kw + n] = ak[:n] * scale
        dv[kv_head, kw:kw + n] = av[:n]

    bkv = DQ[d][0]
    dq = np.zeros_like(qf)
    acc = {}
    for _, bh, r0, kb, edge in dq_tiles(b, hq, sq, skv, d, window):
        kv_head = bh // hq * hkv + bh % hq // (hq // hkv)
        qr, dor = _rows(qf[bh], r0, WG), _rows(dof[bh], r0, WG)
        kt, vt = _rows(kf[kv_head], kb, bkv), _rows(vf[kv_head], kb, bkv)
        s = _f32(qr.astype(np.float64) @ kt.T)
        dp = _f32(dor.astype(np.float64) @ vt.T)
        row, key = r0 + np.arange(WG)[:, None], kb + np.arange(bkv)[None, :]
        keep = (row < sq) & (key < skv)
        keep &= vis[np.minimum(row, sq - 1), np.minimum(key, skv - 1)]
        # Rows past Sq carry products (their stores are clipped) but no masks.
        keep |= row >= sq
        _, ds = p_ds(s, dp, pad(l2f[bh], r0, WG)[:, None], pad(deltaf[bh], r0, WG)[:, None],
                     keep & (key < skv), edge)
        a = acc.get((bh, r0), np.zeros((WG, d), np.float32))
        acc[bh, r0] = _f32(a + ds.astype(np.float64) @ kt)
    for (bh, r0), a in acc.items():
        n = min(WG, sq - r0)
        dq[bh, r0:r0 + n] = a[:n] * scale
    return (dq.reshape(q.shape), dk.reshape(k.shape), dv.reshape(v.shape))


def _inputs(b, hq, hkv, sq, skv, d, seed, bf16):
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=shape).astype(np.float32)
          for shape in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d), (b, hq, sq, d))]
    return [_bf16(x) for x in xs] if bf16 else xs


def _vjp(q, k, v, do, window):
    sq, skv = q.shape[2], k.shape[2]

    def attend(q, k, v):
        return jattn._sdpa(q, k, v, causal=True, window=window or 0, q_offset=skv - sq)
    _, vjp = jax.vjp(attend, *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _close(got, want, tol):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = w.float().numpy() if isinstance(w, torch.Tensor) else np.asarray(w, np.float32)
        err = np.abs(np.asarray(g, dtype=np.float32) - w).max()
        assert err <= tol * np.abs(w).max(), (name, err, np.abs(w).max())


# (b, hq, hkv, sq, skv, d, window): D = 32, 80 and 240; GQA 1, 2 and 5; a
# window edge inside a q tile and a key block; more queries than keys (rows
# that see no key); Sq of 65 and 191 around the 64-row warpgroups, the
# 128-row dQ blocks and the 64-row q tiles; keys past a 128-key block.
SHAPES = [
    (1, 2, 2, 129, 129, 32, None),
    (1, 5, 1, 65, 65, 80, 40),
    (1, 5, 1, 191, 191, 80, None),
    (1, 4, 2, 191, 150, 32, 37),
    (1, 2, 1, 150, 90, 240, None),
    (1, 4, 2, 65, 200, 240, 100),
]


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,window", SHAPES)
def test_bf16_schedule_matches_references(b, hq, hkv, sq, skv, d, window):
    q, k, v, do = _inputs(b, hq, hkv, sq, skv, d, seed=sq + skv + d, bf16=True)
    tq, tk, tv, tdo = (torch.from_numpy(x).bfloat16() for x in (q, k, v, do))
    o = ref.flash_attention(tq, tk, tv, window=window)
    lse = ref.flash_attention_lse(tq, tk, window=window)
    got = [_bf16(g) for g in kernel_bwd(q, k, v, o.float().numpy(), do, lse.numpy(),
                                        window=window)]
    _close(got, ref.flash_attention_bwd(tq, tk, tv, o, tdo, lse, window=window), 2e-2)
    if sq <= skv:
        _close(got, _vjp(q, k, v, do, window), 2e-2)
    else:                              # rows before key 0 see nothing: dq exactly 0
        assert (got[0][:, :, :sq - skv] == 0).all()


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,window", SHAPES)
def test_f32_schedule_holds_f32(b, hq, hkv, sq, skv, d, window):
    """Nothing rounded to bf16: the tile schedule and the masks alone, within
    1e-5 of each gradient's max |value| of the f32 references."""
    q, k, v, do = _inputs(b, hq, hkv, sq, skv, d, seed=sq + skv + d + 1, bf16=False)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o = ref.flash_attention(tq, tk, tv, window=window)
    lse = ref.flash_attention_lse(tq, tk, window=window)
    got = kernel_bwd(q, k, v, o.numpy(), do, lse.numpy(), window=window, round_bf16=False)
    _close(got, ref.flash_attention_bwd(tq, tk, tv, o, tdo, lse, window=window), 1e-5)
    if sq <= skv:
        _close(got, _vjp(q, k, v, do, window), 1e-5)


@pytest.mark.parametrize("d", sorted(DKDV))
@pytest.mark.parametrize("window", [None, 1, 37, 100, 190, 1024])
def test_each_visible_pair_is_visited_once(d, window):
    """Each (q head, row, key) pair a row sees lies in exactly one tile that
    each kernel runs for it, each tile run holds a pair its warpgroup's rows
    and keys see, and each tile run without masks holds only such pairs (the
    dQ kernel's rows past Sq aside, whose stores are clipped); GQA 5:1 over 2
    batch rows. The lengths put a tile's corner on the diagonal (Skv - Sq of
    190) and, with the window of 190, on its edge (Skv - Sq of 63) besides
    the ragged ends."""
    for sq, skv in ((1, 1), (1, 191), (65, 65), (65, 200), (191, 150), (129, 255),
                    (130, 320), (130, 193), (300, 1100), (1100, 300)):
        vis = _visible(sq, skv, window)
        b, hq, hkv = 2, 5, 1
        keys, bq, _ = DKDV[d]
        count = np.zeros((b * hq, sq, skv), np.int32)
        for _, _, kw, bh, q0, edge in dkdv_tiles(b, hq, hkv, sq, skv, d, window):
            tile = vis[q0:q0 + bq, kw:kw + WG]
            assert tile.any(), (sq, skv, kw, q0)
            assert edge or (tile.shape == (bq, WG) and tile.all()), (sq, skv, kw, q0)
            count[bh, q0:q0 + bq, kw:kw + WG] += tile
        assert (count == vis[None]).all(), (d, window, sq, skv, "dK/dV")
        count[:] = 0
        bkv = DQ[d][0]
        for _, bh, r0, kb, edge in dq_tiles(b, hq, sq, skv, d, window):
            tile = vis[r0:r0 + WG, kb:kb + bkv]
            assert tile.any(), (sq, skv, r0, kb)
            assert edge or (tile.shape[1] == bkv and tile.all()), (sq, skv, r0, kb)
            count[bh, r0:r0 + WG, kb:kb + bkv] += tile
        assert (count == vis[None]).all(), (d, window, sq, skv, "dQ")


@pytest.mark.parametrize("batch,hq,hkv,s,d,window", [(2, 32, 8, 2048, 80, None),
                                                     (2, 16, 16, 2048, 128, None),
                                                     (2, 25, 5, 2048, 64, 1024),
                                                     (8, 16, 16, 448, 64, None),
                                                     (2, 16, 8, 2048, 240, None),
                                                     (2, 16, 8, 2048, 240, 1024),
                                                     (3, 5, 1, 300, 32, 100)])
def test_grid_order_covers_every_block_longest_first(batch, hq, hkv, s, d, window):
    """Each kernel's order maps one to one onto its blocks: (kv head, key
    block) for dK/dV, (head, q block) for dQ. Without a window the tiles a
    block runs never grow along the order: longest first."""
    keys, bq, _ = DKDV[d]
    kv_heads, nkb = batch * hkv, -(-s // keys)
    order = [kv_block_at(x, kv_heads, s, s, window, d) for x in range(kv_heads * nkb)]
    assert sorted((h, k0) for h, k0, _, _ in order) == [
        (h, kb * keys) for h in range(kv_heads) for kb in range(nkb)]
    bhs, nqb = batch * hq, -(-s // DQ_ROWS)
    qorder = [q_block_at(x, bhs, s, s, window, d) for x in range(bhs * nqb)]
    assert sorted((bh, q0) for bh, q0, _, _ in qorder) == [
        (bh, qb * DQ_ROWS) for bh in range(bhs) for qb in range(nqb)]
    if window is None:
        lengths = [n_qt for _, _, _, n_qt in order]
        assert lengths == sorted(lengths, reverse=True)
        lengths = [n for _, _, _, n in qorder]
        assert lengths == sorted(lengths, reverse=True)
