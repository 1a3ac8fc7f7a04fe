"""The arithmetic and schedule of the f32 ``flash_attention`` backward, on the CPU.

The kernels (``src/repro_torch/kernels/csrc/flash_attention_bwd.cu``) run on
Hopper with TF32 wgmma fed by TMA. Each block is a cluster of two CTAs split
by output. The dK/dV kernel takes blocks of 64 keys of one (batch, kv head)
and walks the q tiles of BT rows of each q head of the group whose rows see
some key of the block: CTA 0 computes S^T = K Q^T, P^T and dV += P^T dO,
CTA 1 dP^T = V dO^T, dS^T from the P^T it receives, and dK += dS^T Q. The
dQ kernel takes blocks of 64 q rows over the key tiles of BT keys the rows
may see: CTA 0 computes S = Q K^T and P, CTA 1 dP = dO V^T, dS and
dQ += dS K. Every product runs in three TF32 passes with the split of
``csrc/tf32.cuh`` (x = hi + lo, a non-finite x all lo): the two small passes
of S and dP into an accumulator of their own, added after the last k-step,
and each tile's dV, dK or dQ product into a fresh accumulator, added to the
running sum in f32. Masks apply only on tiles that cross the diagonal, the
window edge, or the end of the keys or rows. Blocks go key blocks first to
last (dK/dV) and q blocks last to first (dQ).

Here that schedule is walked tile by tile in numpy, with every tile constant
read from the ``.cu`` source, so the walk cannot drift from the kernel's
tiling: TF32 rounding by bit arithmetic (``torch_parity.split`` / ``tf32``),
one f32 rounding per wgmma k-step of 8, P and dS split with the finiteness
test. The same numpy-seeded q, k, v and dO go through the walk, through the
port's plain backward (``ref.flash_attention_bwd``) and through ``jax.vjp``
of the JAX package's ``repro.models.attention._sdpa`` (where no row is fully
masked: the reference masks with -1e30), each within 1e-5 of each
gradient's max |value|; one pass (hi x hi in every product) misses 1e-5.
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
from torch_parity import split

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
          / "flash_attention_bwd.cu").read_text()
LOG2E = np.float32(1.4426950408889634)
TOL = 1e-5


def _constexpr(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


ROWS = _constexpr("ROWS")          # keys (dK/dV) or q rows (dQ) of a block
CONSUMERS = _constexpr("CONSUMERS")   # warpgroups taking a block's tiles in turn
TILING = {int(d): dict((k, int(v)) for k, v in re.findall(r"(\w+) = (\d+)", fields))
          for d, fields in re.findall(
              r"struct F32Tiling<(\d+)> \{\s*static constexpr int ([^;]*);\s*\};", SOURCE)}


def test_source_constants():
    """The tiling the walk reads is the kernel's: one entry per head dim of
    the wrapper, 64 keys or rows a block (one warpgroup's wgmma rows), two
    consumer warpgroups, tiles of whole k-steps of 8 and fresh accumulators
    that divide the head dim."""
    assert ROWS == 64 and CONSUMERS == 2 and sorted(TILING) == sorted(kflash.HEAD_DIMS)
    for d, f in TILING.items():
        assert f["BT"] % 16 == 0 and f["STAGES"] >= 2 and f["HOLD"] in (0, 1), d
        assert d % f["DCH"] == 0 and f["DCH"] % 8 == 0, d
    assert "__cluster_dims__(2, 1, 1)" in SOURCE


# -- the kernels' index arithmetic, line for line -------------------------------

def rows_seeing(k_first, k_last, sq, skv, window):
    off = skv - sq
    i_lo = max(0, k_first - off)
    i_hi = min(sq - 1, k_last + window - 1 - off) if window else sq - 1
    return i_lo, i_hi


def kv_block_at(x, kv_heads, sq, skv, window, d):
    """(kv_head, k0, qt0, n_qt) of dK/dV block x."""
    bt = TILING[d]["BT"]
    kv_head, k0 = x % kv_heads, x // kv_heads * ROWS
    i_lo, i_hi = rows_seeing(k0, min(k0 + ROWS, skv) - 1, sq, skv, window)
    qt0 = i_lo // bt
    return kv_head, k0, qt0, (i_hi // bt - qt0 + 1 if i_hi >= i_lo else 0)


def q_block_at(x, bhs, hq, hkv, sq, skv, window, d):
    """(bh, q0, kv_head, kb0, n_tiles) of dQ block x."""
    bt = TILING[d]["BT"]
    nqb = -(-sq // ROWS)
    bh, q0 = x % bhs, (nqb - 1 - x // bhs) * ROWS
    b = bh // hq
    kv_head = b * hkv + (bh - b * hq) // (hq // hkv)
    off = skv - sq
    k_hi = min(skv, min(q0 + ROWS, sq) + off) - 1
    k_lo = max(0, q0 + off - window + 1) if window else 0
    kb0 = k_lo // bt * bt
    return bh, q0, kv_head, kb0, ((k_hi - kb0) // bt + 1 if k_hi >= kb0 else 0)


def kv_edge(k0, q0, sq, skv, window, bt):
    off = skv - sq
    return (k0 + ROWS - 1 > q0 + off or k0 + ROWS > skv or q0 + bt > sq
            or (bool(window) and k0 <= q0 + bt - 1 + off - window))


def q_edge(kb, qpos0, skv, window, bt):
    return (kb + bt - 1 > qpos0 or kb + bt > skv
            or (bool(window) and kb <= qpos0 + ROWS - 1 - window))


def dkdv_tiles(b, hq, hkv, sq, skv, d, window):
    """The dK/dV kernel's tiles in grid order: (block, kv head, k0, q head,
    first row q0, masked, the tile's index in its block)."""
    bt = TILING[d]["BT"]
    group, kv_heads = hq // hkv, b * hkv
    for x in range(kv_heads * -(-skv // ROWS)):
        kv_head, k0, qt0, n_qt = kv_block_at(x, kv_heads, sq, skv, window, d)
        bb, h = divmod(kv_head, hkv)
        for j in range(group * n_qt):
            hg, qt = divmod(j, n_qt)
            q0 = (qt0 + qt) * bt
            yield (x, kv_head, k0, bb * hq + h * group + hg, q0,
                   kv_edge(k0, q0, sq, skv, window, bt), j)


def dq_tiles(b, hq, hkv, sq, skv, d, window):
    """The dQ kernel's tiles in grid order: (block, head, q0, kv head, first
    key kb, masked, the tile's index in its block)."""
    bt, bhs = TILING[d]["BT"], b * hq
    for x in range(bhs * -(-sq // ROWS)):
        bh, q0, kv_head, kb0, n_tiles = q_block_at(x, bhs, hq, hkv, sq, skv, window, d)
        for j in range(n_tiles):
            kb = kb0 + j * bt
            yield x, bh, q0, kv_head, kb, q_edge(kb, q0 + skv - sq, skv, window, bt), j


def _visible(sq, skv, window):
    qpos = np.arange(sq)[:, None] + skv - sq
    kpos = np.arange(skv)[None, :]
    keep = kpos <= qpos
    if window:
        keep &= kpos > qpos - window
    return keep


# -- the walk ------------------------------------------------------------------

def _f32(x):
    return np.asarray(x, dtype=np.float64).astype(np.float32)


def _rows(x, r0, n):
    """Rows [r0, r0 + n) of x [S, D] as TMA loads them: zeros past S."""
    out = np.zeros((n, x.shape[1]), np.float32)
    m = max(0, min(n, x.shape[0] - r0))
    out[:m] = x[r0:r0 + m]
    return out


def _split(x, passes):
    """(hi, lo) of x with tf32.cuh's rule; one pass keeps hi alone."""
    hi, lo = split(x)
    return (hi, np.zeros_like(x)) if passes == 1 else (hi, lo)


def _product(a, b, passes, apart):
    """a @ b as the kernel's wgmma k-steps of 8, from a = (hi, lo) [M, K] and
    b = (hi, lo) [K, N], one f32 rounding per k-step. ``apart`` (S and dP):
    the two small passes into an accumulator of their own, added to the
    large one after the last k-step. Otherwise (a tile's dV, dK or dQ): all
    three into one fresh accumulator, the small ones first."""
    (a_hi, a_lo), (b_hi, b_lo) = a, b
    big = np.zeros((a_hi.shape[0], b_hi.shape[1]), np.float32)
    small = np.zeros_like(big)

    def mma(acc, x, y):
        return _f32(acc.astype(np.float64) + x.astype(np.float64) @ y.astype(np.float64))
    for c in range(0, a_hi.shape[1], 8):
        ka = slice(c, c + 8)
        if passes == 3:
            tgt = small if apart else big
            tgt = mma(tgt, a_lo[:, ka], b_hi[ka])
            tgt = mma(tgt, a_hi[:, ka], b_lo[ka])
            if apart:
                small = tgt
            else:
                big = tgt
        big = mma(big, a_hi[:, ka], b_hi[ka])
    return _f32(big.astype(np.float64) + small) if apart else big


def kernel_bwd(q, k, v, o, do, lse, *, window=None, passes=3):
    """(dq, dk, dv) as the kernels compute them, from f32 arrays q, o, do
    [B, Hq, Sq, D], k, v [B, Hkv, Skv, D] and lse [B, Hq, Sq]. Consumer c
    of a block sums the tiles c, c + 2, ... of it; consumer 0 then adds
    consumer 1's sums to its own."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    bt = TILING[d]["BT"]
    scale = np.float32(1.0 / math.sqrt(d))
    sl2 = np.float32(scale * LOG2E)
    delta = np.sum(do * o, axis=-1, dtype=np.float32)          # the D pass
    l2 = _f32(lse.astype(np.float64) * LOG2E)
    qf, dof = q.reshape(b * hq, sq, d), do.reshape(b * hq, sq, d)
    kf, vf = k.reshape(b * hkv, skv, d), v.reshape(b * hkv, skv, d)
    l2f, deltaf = l2.reshape(b * hq, sq), delta.reshape(b * hq, sq)
    vis = _visible(sq, skv, window)
    pad = lambda x, r0, n: np.pad(x, (0, n))[r0:r0 + n]  # noqa: E731
    sp = lambda x: _split(x, passes)  # noqa: E731

    def keep_of(rows, keys):
        keep = (rows < sq) & (keys < skv)
        return keep & vis[np.minimum(rows, sq - 1), np.minimum(keys, skv - 1)]

    def p_ds(s, dp, lrow, drow, keep, edge):
        with np.errstate(over="ignore", invalid="ignore"):
            p = np.exp2(_f32(s.astype(np.float64) * sl2 - lrow)).astype(np.float32)
            ds = _f32(p.astype(np.float64) * _f32(dp.astype(np.float64) - drow))
        if edge:
            return np.where(keep, p, np.float32(0)), np.where(keep, ds, np.float32(0))
        assert keep.all()           # an interior tile: every pair is visible
        return p, ds

    zero = np.zeros((ROWS, d), np.float32)
    dk, dv = np.zeros_like(kf), np.zeros_like(vf)
    acc = {}
    for _, kv_head, k0, bh, q0, edge, j in dkdv_tiles(b, hq, hkv, sq, skv, d, window):
        kt, vt = _rows(kf[kv_head], k0, ROWS), _rows(vf[kv_head], k0, ROWS)
        qt, dot = _rows(qf[bh], q0, bt), _rows(dof[bh], q0, bt)
        qs, dos = sp(qt), sp(dot)
        st = _product(sp(kt), (qs[0].T, qs[1].T), passes, True)       # S^T = K Q^T
        dpt = _product(sp(vt), (dos[0].T, dos[1].T), passes, True)    # dP^T = V dO^T
        keep = keep_of(q0 + np.arange(bt)[None, :], k0 + np.arange(ROWS)[:, None])
        pt, dst = p_ds(st, dpt, pad(l2f[bh], q0, bt)[None], pad(deltaf[bh], q0, bt)[None], keep,
                       edge)
        key = (kv_head, k0, j % CONSUMERS)
        ak, av = acc.get(key, (zero, zero))
        acc[key] = (_f32(ak + _product(sp(dst), qs, passes, False)),   # dK += dS^T Q
                    _f32(av + _product(sp(pt), dos, passes, False)))   # dV += P^T dO
    for (kv_head, k0, c), (ak, av) in acc.items():
        if c:
            continue
        ak1, av1 = acc.get((kv_head, k0, 1), (zero, zero))
        n = min(ROWS, skv - k0)
        dk[kv_head, k0:k0 + n] = (_f32(ak + ak1) * scale)[:n]
        dv[kv_head, k0:k0 + n] = _f32(av + av1)[:n]

    dq = np.zeros_like(qf)
    acc = {}
    for _, bh, q0, kv_head, kb, edge, j in dq_tiles(b, hq, hkv, sq, skv, d, window):
        qr, dor = _rows(qf[bh], q0, ROWS), _rows(dof[bh], q0, ROWS)
        ks, vs = sp(_rows(kf[kv_head], kb, bt)), sp(_rows(vf[kv_head], kb, bt))
        s = _product(sp(qr), (ks[0].T, ks[1].T), passes, True)        # S = Q K^T
        dp = _product(sp(dor), (vs[0].T, vs[1].T), passes, True)      # dP = dO V^T
        keep = keep_of(q0 + np.arange(ROWS)[:, None], kb + np.arange(bt)[None, :])
        # Rows past Sq carry products (their stores are clipped) but no masks.
        if not edge:
            keep |= q0 + np.arange(ROWS)[:, None] >= sq
        _, ds = p_ds(s, dp, pad(l2f[bh], q0, ROWS)[:, None], pad(deltaf[bh], q0, ROWS)[:, None],
                     keep, edge)
        key = (bh, q0, j % CONSUMERS)
        acc[key] = _f32(acc.get(key, zero) + _product(sp(ds), ks, passes, False))   # dQ += dS K
    for (bh, q0, c), a in acc.items():
        if c:
            continue
        n = min(ROWS, sq - q0)
        dq[bh, q0:q0 + n] = (_f32(a + acc.get((bh, q0, 1), zero)) * scale)[:n]
    return dq.reshape(q.shape), dk.reshape(k.shape), dv.reshape(v.shape)


def _inputs(b, hq, hkv, sq, skv, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d), (b, hq, sq, d))]


def _forward(q, k, v, window):
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    return (ref.flash_attention(tq, tk, tv, window=window).numpy(),
            ref.flash_attention_lse(tq, tk, window=window).numpy())


def _vjp(q, k, v, do, window):
    sq, skv = q.shape[2], k.shape[2]

    def attend(q, k, v):
        return jattn._sdpa(q, k, v, causal=True, window=window or 0, q_offset=skv - sq)
    _, vjp = jax.vjp(attend, *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _close(got, want, tol=TOL):
    return [float(np.abs(np.asarray(g, np.float32) - np.asarray(w, np.float32)).max()
                  / max(np.abs(np.asarray(w, np.float32)).max(), 1e-30))
            for g, w in zip(got, want)]


# (b, hq, hkv, sq, skv, d, window): D = 80 and 240; GQA 5:1 and 2:1; a window
# whose edge falls inside a q tile and a key block; more queries than keys
# (rows that see no key); Sq of 65 and 191 around the 64-row blocks and the
# tiles of 16 or 32.
SHAPES = [
    (1, 5, 1, 65, 65, 80, 40),
    (1, 5, 1, 191, 191, 80, None),
    (1, 4, 2, 150, 90, 80, None),
    (1, 2, 1, 65, 65, 240, 21),
    (1, 4, 2, 96, 60, 240, None),
    (1, 5, 1, 70, 191, 240, None),
]


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,window", SHAPES)
def test_f32_schedule_matches_references(b, hq, hkv, sq, skv, d, window):
    q, k, v, do = _inputs(b, hq, hkv, sq, skv, d, seed=sq + skv + d)
    o, lse = _forward(q, k, v, window)
    got = kernel_bwd(q, k, v, o, do, lse, window=window)
    plain = ref.flash_attention_bwd(*(torch.from_numpy(x) for x in (q, k, v, o, do, lse)),
                                    window=window)
    errs = _close(got, [p.numpy() for p in plain])
    assert max(errs) <= TOL, ("plain", errs)
    if sq <= skv:
        errs = _close(got, _vjp(q, k, v, do, window))
        assert max(errs) <= TOL, ("jax.vjp", errs)
    else:                              # rows before key 0 see nothing: dq exactly 0
        assert (got[0][:, :, :sq - skv] == 0).all()


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,window", SHAPES[::3])
def test_one_pass_misses_f32(b, hq, hkv, sq, skv, d, window):
    q, k, v, do = _inputs(b, hq, hkv, sq, skv, d, seed=sq + skv + d)
    o, lse = _forward(q, k, v, window)
    one = kernel_bwd(q, k, v, o, do, lse, window=window, passes=1)
    plain = ref.flash_attention_bwd(*(torch.from_numpy(x) for x in (q, k, v, o, do, lse)),
                                    window=window)
    assert max(_close(one, [p.numpy() for p in plain])) > TOL


@pytest.mark.parametrize("d", sorted(TILING))
@pytest.mark.parametrize("window", [None, 1, 37, 100, 190])
def test_each_visible_pair_is_visited_once(d, window):
    """Each (q head, row, key) pair a row sees lies in exactly one tile that
    each kernel runs, each tile run holds a pair its block sees, and each
    tile run without masks holds only such pairs (the dQ kernel's rows past
    Sq aside, whose stores are clipped); GQA 5:1 over 2 batch rows. The
    lengths put a tile's corner on the diagonal (Skv - Sq of 190) and, with
    the window of 190, on its edge (Skv - Sq of 63) besides the ragged ends."""
    bt = TILING[d]["BT"]
    for sq, skv in ((1, 1), (1, 191), (65, 65), (65, 200), (191, 150), (129, 255),
                    (130, 193), (300, 700)):
        vis = _visible(sq, skv, window)
        b, hq, hkv = 2, 5, 1
        count = np.zeros((b * hq, sq, skv), np.int32)
        for _, _, k0, bh, q0, edge, _ in dkdv_tiles(b, hq, hkv, sq, skv, d, window):
            tile = vis[q0:q0 + bt, k0:k0 + ROWS]
            assert tile.any(), (sq, skv, k0, q0)
            assert edge or (tile.shape == (bt, ROWS) and tile.all()), (sq, skv, k0, q0)
            count[bh, q0:q0 + bt, k0:k0 + ROWS] += tile
        assert (count == vis[None]).all(), (d, window, sq, skv, "dK/dV")
        count[:] = 0
        for _, bh, q0, _, kb, edge, _ in dq_tiles(b, hq, hkv, sq, skv, d, window):
            tile = vis[q0:q0 + ROWS, kb:kb + bt]
            assert tile.any(), (sq, skv, q0, kb)
            assert edge or (tile.shape[1] == bt and tile.all()), (sq, skv, q0, kb)
            count[bh, q0:q0 + ROWS, kb:kb + bt] += tile
        assert (count == vis[None]).all(), (d, window, sq, skv, "dQ")


@pytest.mark.parametrize("batch,hq,hkv,s,d,window", [(2, 32, 8, 2048, 80, None),
                                                     (2, 16, 8, 2048, 240, None),
                                                     (2, 16, 8, 2048, 240, 1024),
                                                     (3, 5, 1, 300, 32, 100)])
def test_grid_covers_every_block_once_longest_first(batch, hq, hkv, s, d, window):
    """Each kernel's grid (two CTAs a block) maps one to one onto its blocks:
    (kv head, key block) for dK/dV, (head, q block) for dQ. Without a window
    the tiles a block runs never grow along the grid: longest first."""
    kv_heads, nkb = batch * hkv, -(-s // ROWS)
    order = [kv_block_at(x, kv_heads, s, s, window, d) for x in range(kv_heads * nkb)]
    assert sorted((h, k0) for h, k0, _, _ in order) == [
        (h, kb * ROWS) for h in range(kv_heads) for kb in range(nkb)]
    bhs, nqb = batch * hq, -(-s // ROWS)
    qorder = [q_block_at(x, bhs, hq, hkv, s, s, window, d) for x in range(bhs * nqb)]
    assert sorted((bh, q0) for bh, q0, _, _, _ in qorder) == [
        (bh, qb * ROWS) for bh in range(bhs) for qb in range(nqb)]
    if window is None:
        lengths = [n_qt for _, _, _, n_qt in order]
        assert lengths == sorted(lengths, reverse=True)
        lengths = [n for _, _, _, _, n in qorder]
        assert lengths == sorted(lengths, reverse=True)
