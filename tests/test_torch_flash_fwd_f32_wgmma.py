"""The arithmetic and schedule of the f32 ``flash_attention`` forward, on the CPU.

The kernel (``src/repro_torch/kernels/csrc/flash_attention.cu``) runs on
Hopper with TF32 wgmma fed by TMA. A pre-pass splits K and V once per call
into TF32 planes (``tf32_split_kernel`` of ``csrc/tf32.cuh``: x = hi + lo, a
non-finite x all lo), V transposed with each group of 8 keys in the order
0 2 4 6 1 3 5 7. A CTA's two consumer warpgroups take a block of query rows
of one (batch, q head): 64 each of a 128-row block, both reading every key
tile of BKV keys, or (``SPLIT``, D = 240) the same 64 rows, taking the
block's tiles in turn and merging their running max, sum and output at the
end. Per tile, S = Q Kᵀ in three TF32 passes, the two small ones into an
accumulator of their own added after the last k-step; masks only on tiles
that cross a consumer's diagonal, window edge or the end of the keys; the
online softmax in log2 units with the scale folded into one FMA; P split
without the finiteness test; P V in three passes into a fresh accumulator
added to the rescaled output in f32.

Here that schedule is walked in numpy, with every tile constant read from
the ``.cu`` source (so the walk cannot drift from the kernel's tiling): TF32
rounding by bit arithmetic (``torch_parity.split`` / ``tf32``), one f32
rounding per wgmma k-step of 8. The same numpy-seeded q, k, v go through the
walk, the port's plain version (``ref.flash_attention`` and
``ref.flash_attention_lse``) and the JAX package's
``repro.kernels.ref.flash_attention`` with the kv heads repeated, within 1e-5
(absolute and relative; the log-sum-exp within 1e-5); one pass (hi x hi in
every product) misses 1e-5.
"""
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import ref
from torch_parity import split, tf32

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
SOURCE = (CSRC / "flash_attention.cu").read_text()
SPLIT_SOURCE = (CSRC / "tf32.cuh").read_text()
LOG2E = np.float32(1.4426950408889634)
LN2 = np.float32(0.6931471805599453)
TOL = 1e-5
GPU_NAN = np.array([0x7FFFFFFF], dtype=np.uint32).view(np.float32)[0]   # what ex2 gives


def _constexpr(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


CONSUMERS = _constexpr("CONSUMERS")   # consumer warpgroups of 64 rows
KCH = _constexpr("KCH")               # k-steps of Q split at a time where HOLD is 0
TILING = {int(d): dict((k, int(v)) for k, v in re.findall(r"(\w+) = (\d+)", fields))
          for d, fields in re.findall(
              r"struct Tiling<(\d+)> \{ static constexpr int ([^;]*); \};", SOURCE)}
L2_KV_BYTES = 16 << int(re.search(r"L2_KV_BYTES = 16u << (\d+);", SOURCE).group(1))


def _bq(d):
    return 64 if TILING[d]["SPLIT"] else 64 * CONSUMERS


def test_source_constants():
    """The tiling the walk reads is the kernel's: one entry per head dim of
    the wrapper, two consumer warpgroups of 64 rows, key tiles of whole
    k-steps that the 128- or 64-byte swizzle boxes of the transposed V planes
    divide, fresh P V accumulators that divide the head dim, Q's fragments
    held in registers where they fit (D <= 80) and SPLIT where 128 rows of
    raw Q would not fit beside two stages (D = 240)."""
    assert CONSUMERS == 2 and KCH >= 1 and sorted(TILING) == sorted(kflash.HEAD_DIMS)
    for d, f in TILING.items():
        assert f["BKV"] % 16 == 0 and (f["BKV"] % 32 == 0 or f["BKV"] == 16), d
        assert f["STAGES"] >= 2 and d % f["DCH"] == 0 and f["DCH"] % 8 == 0, d
        assert f["HOLD"] == (d <= 80) and f["SPLIT"] == (d == 240), d
    assert "mma.sync" not in SOURCE


def test_fragment_key_orders_agree():
    """P's A fragment and V's B operand hold the same key at every k index
    of a k-step of 8. The kernel turns accumulator element e of lane (g, t)
    (key 2t + (e & 1)) into A element (e >> 1) | ((e & 1) << 1), which is k
    index t + 4 (a >> 1); the pre-pass writes key r of each group of 8 to
    the transposed plane's position given by the rule read from tf32.cuh,
    and k index i of B reads position i. Both give keys 0 2 4 6 1 3 5 7."""
    a_rule = re.search(r"const int a = (.*);", SOURCE).group(1)
    assert a_rule == "(e >> 1) | ((e & 1) << 1)"
    a_keys = np.full(8, -1)
    for t in range(4):
        for e in range(4):
            a = (e >> 1) | ((e & 1) << 1)
            assert (a & 1) == (e >> 1)                # the same row
            a_keys[t + 4 * (a >> 1)] = 2 * t + (e & 1)
    pos_rule = re.search(r"const int pos = (.*);", SPLIT_SOURCE).group(1)
    assert pos_rule == "(row & ~7) | ((row & 7) >> 1) | ((row & 1) << 2)"
    b_keys = np.full(8, -1)
    for row in range(8):
        b_keys[(row & ~7) | ((row & 7) >> 1) | ((row & 1) << 2)] = row
    np.testing.assert_array_equal(a_keys, [0, 2, 4, 6, 1, 3, 5, 7])
    np.testing.assert_array_equal(b_keys, a_keys)


# -- the kernel's index arithmetic, line for line -------------------------------

def block_at(x, group, bhs, hq, hkv, sq, skv, window, d):
    """(bh, q0, kv_head, kb0, n_tiles) of block x of the grid's order."""
    bq, bkv = _bq(d), TILING[d]["BKV"]
    nqb = -(-sq // bq)
    g0 = x // (group * nqb) * group
    gs = min(group, bhs - g0)
    in_group = x - g0 * nqb
    bh = g0 + in_group % gs
    q0 = (nqb - 1 - in_group // gs) * bq
    b = bh // hq
    kv_head = b * hkv + (bh - b * hq) // (hq // hkv)
    off = skv - sq
    k_hi = min(skv, min(q0 + bq, sq) + off) - 1
    k_lo = max(0, q0 + off - window + 1) if window else 0
    kb0 = k_lo // bkv * bkv
    return bh, q0, kv_head, kb0, ((k_hi - kb0) // bkv + 1 if k_hi >= kb0 else 0)


def group_of(b, hq, hkv, skv, d):
    """Heads a group of the grid's order holds (the launch's rule)."""
    kv_bytes = 16 * max(skv, 1) * d
    fit = L2_KV_BYTES // kv_bytes
    return (1 if fit < 1 else min(fit, b * hkv)) * (hq // hkv)


def consumer_tiles(c, q0, kb0, n_tiles, sq, skv, window, d):
    """Consumer c's first row r0 and the tiles it computes, each (j, kb,
    masked): its 64 rows (of a 128-row block, or with SPLIT the block's
    own, taking tiles c, c + 2, ...), the tiles [j_lo, j_hi) some row of
    them may see."""
    bkv, split_ = TILING[d]["BKV"], TILING[d]["SPLIT"]
    r0 = q0 + (0 if split_ else 64 * c)
    qpos0 = r0 + skv - sq
    j_lo = j_hi = 0
    if r0 < sq and n_tiles > 0:
        k_last, k_first = qpos0 + 63, (qpos0 - window + 1 if window else 0)
        j_hi = min(n_tiles, (k_last - kb0) // bkv + 1) if k_last >= kb0 else 0
        j_lo = (k_first - kb0) // bkv if k_first > kb0 else 0
        if j_lo >= j_hi:
            j_lo = j_hi = 0
    tiles = []
    for j in range(c if split_ else 0, n_tiles, CONSUMERS if split_ else 1):
        if j_lo <= j < j_hi:
            kb = kb0 + j * bkv
            edge = (kb + bkv - 1 > qpos0 or kb + bkv > skv
                    or (bool(window) and kb <= qpos0 + 63 - window))
            tiles.append((j, kb, edge))
    return r0, tiles


def schedule(b, hq, hkv, sq, skv, d, window):
    """The kernel's work in grid order: (block x, bh, kv head, consumer c,
    first row r0, tiles)."""
    bhs = b * hq
    group = group_of(b, hq, hkv, skv, d)
    for x in range(bhs * -(-sq // _bq(d))):
        bh, q0, kv_head, kb0, n_tiles = block_at(x, group, bhs, hq, hkv, sq, skv, window, d)
        for c in range(CONSUMERS):
            yield (x, bh, kv_head, c) + consumer_tiles(c, q0, kb0, n_tiles, sq, skv, window, d)


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


def _product(a, b, passes, apart):
    """a @ b as the kernel's wgmma k-steps of 8, from a = (hi, lo) [M, K] and
    b = (hi, lo) [K, N], one f32 rounding per k-step. ``apart`` (S): the two
    small passes into an accumulator of their own, added to the large one
    after the last k-step. Otherwise (a tile's P V): all three into one fresh
    accumulator, the small ones first."""
    (a_hi, a_lo), (b_hi, b_lo) = a, b
    big = np.zeros((a_hi.shape[0], b_hi.shape[1]), np.float32)
    small = np.zeros_like(big)

    def mma(acc, x, y):
        with np.errstate(invalid="ignore", over="ignore"):
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


def kernel_fwd(q, k, v, *, window=None, passes=3):
    """(out, lse) as the kernel computes them, from f32 arrays q [B, Hq, Sq,
    D] and k, v [B, Hkv, Skv, D]."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    bkv = TILING[d]["BKV"]
    sl2 = np.float32(np.float32(1.0 / math.sqrt(d)) * LOG2E)
    qf = q.reshape(b * hq, sq, d)
    kf, vf = k.reshape(b * hkv, skv, d), v.reshape(b * hkv, skv, d)
    one = (lambda x: (split(x)[0], np.zeros_like(x))) if passes == 1 else split  # noqa: E731
    kh, vh = [one(x) for x in kf], [one(x) for x in vf]      # the pre-pass's planes
    vis = _visible(sq, skv, window)
    out = np.zeros_like(qf)
    lse = np.zeros((b * hq, sq), np.float32)
    state = {}                                   # (block, consumer) -> (m, l, o, r0, bh)
    for x, bh, kv_head, c, r0, tiles in schedule(b, hq, hkv, sq, skv, d, window):
        qs = one(_rows(qf[bh], r0, 64))
        rows = r0 + np.arange(64)
        m = np.full(64, -np.inf, np.float32)
        l = np.zeros(64, np.float32)
        o = np.zeros((64, d), np.float32)
        for _, kb, edge in tiles:
            kt = [_rows(p, kb, bkv) for p in kh[kv_head]]
            s = _product(qs, (kt[0].T, kt[1].T), passes, True)      # S = Q K^T
            keys = kb + np.arange(bkv)
            keep = ((rows[:, None] < sq) & (keys[None] < skv)
                    & vis[np.minimum(rows, sq - 1)[:, None], np.minimum(keys, skv - 1)[None]])
            if edge:
                qpos = rows[:, None] + skv - sq
                ok = (keys[None] <= qpos) & (keys[None] < skv)
                if window:
                    ok &= keys[None] > qpos - window
                s = np.where(ok, s, np.float32(-np.inf))
            else:
                assert keep[rows < sq].all()      # an interior tile: every pair is visible
            with np.errstate(invalid="ignore"):
                mx = _f32(np.fmax.reduce(s, axis=1).astype(np.float64) * sl2)
            m_new = np.fmax(m, mx)
            m_use = np.where(m_new == -np.inf, np.float32(0), m_new).astype(np.float32)
            alpha = np.exp2(m - m_use).astype(np.float32)
            m = m_new
            with np.errstate(invalid="ignore"):
                p = np.exp2(_f32(s.astype(np.float64) * sl2 - m_use[:, None])).astype(np.float32)
            p = np.where(np.isnan(p), GPU_NAN, p)
            l = _f32(_f32(l.astype(np.float64) * alpha) + p.sum(1, dtype=np.float64))
            o = _f32(o.astype(np.float64) * alpha[:, None])
            p_hi = tf32(p)                        # no finiteness test: NaN -> -0
            p_lo = tf32(p - p_hi)
            if passes == 1:
                p_lo = np.zeros_like(p)
            vt = [_rows(pl, kb, bkv) for pl in vh[kv_head]]
            o = _f32(o.astype(np.float64) + _product((p_hi, p_lo), vt, passes, False))
        state[x, c] = (m, l, o, r0, bh)
    for (x, c), (m, l, o, r0, bh) in state.items():
        if TILING[d]["SPLIT"]:
            if c == 1:
                continue
            m1, l1, o1, _, _ = state[x, 1]        # consumer 1's, merged into consumer 0's
            mx = np.fmax(m, m1)
            mu = np.where(mx == -np.inf, np.float32(0), mx).astype(np.float32)
            a0, a1 = np.exp2(m - mu).astype(np.float32), np.exp2(m1 - mu).astype(np.float32)
            l = _f32(l.astype(np.float64) * a0 + l1.astype(np.float64) * a1)
            o = _f32(o.astype(np.float64) * a0[:, None] + o1.astype(np.float64) * a1[:, None])
            m = mx
        n = max(0, min(64, sq - r0))
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = np.where(l == 0, np.float32(0), _f32(1.0 / l.astype(np.float64)))
            out[bh, r0:r0 + n] = _f32(o.astype(np.float64) * inv[:, None])[:n]
            lse[bh, r0:r0 + n] = np.where(
                l == 0, np.float32(-np.inf),
                _f32((m.astype(np.float64) + np.log2(l.astype(np.float64))) * LN2))[:n]
    return out.reshape(q.shape), lse.reshape(b, hq, sq)


def _inputs(b, hq, hkv, sq, skv, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))


# (b, hq, hkv, sq, skv, d, window): D = 80 (Q held in registers, 64-key
# tiles) with GQA 2:1 over 128-row blocks and a ragged last block; fewer
# queries than keys with a window that crosses tiles; D = 128 (Q split at
# use, 32-key tiles) with MQA and a window; D = 240 (SPLIT: 64-row blocks,
# the consumers taking 16-key tiles in turn, then merged) with GQA 2:1 and a
# window, fewer queries than keys, and more queries than keys (rows that see
# no key).
SHAPES = [(1, 4, 2, 150, 150, 80, None), (1, 2, 1, 77, 301, 80, 100),
          (1, 2, 1, 200, 200, 128, 64), (1, 4, 2, 100, 100, 240, 40),
          (1, 2, 1, 60, 141, 240, None), (1, 2, 1, 90, 70, 240, None)]


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,window", SHAPES)
def test_schedule_holds_f32(b, hq, hkv, sq, skv, d, window):
    q, k, v = _inputs(b, hq, hkv, sq, skv, d, seed=sq + skv + d)
    got, lse = kernel_fwd(q, k, v, window=window)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    plain = ref.flash_attention(tq, tk, tv, window=window).numpy()
    np.testing.assert_allclose(got, plain, atol=TOL, rtol=TOL)
    plain_lse = ref.flash_attention_lse(tq, tk, window=window).numpy()
    seen = np.isfinite(plain_lse)
    np.testing.assert_array_equal(np.isfinite(lse), seen)
    np.testing.assert_allclose(lse[seen], plain_lse[seen], atol=TOL, rtol=0)
    rep = hq // hkv
    oracle = jref.flash_attention(jnp.asarray(q), jnp.asarray(np.repeat(k, rep, 1)),
                                  jnp.asarray(np.repeat(v, rep, 1)), causal=True, window=window)
    np.testing.assert_allclose(got, np.asarray(oracle), atol=TOL, rtol=TOL)
    if sq > skv:                              # rows before key 0 see nothing: exact 0
        assert (got[:, :, :sq - skv] == 0).all()


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,window", SHAPES[::2])
def test_one_pass_misses_f32(b, hq, hkv, sq, skv, d, window):
    q, k, v = _inputs(b, hq, hkv, sq, skv, d, seed=sq + skv + d)
    one, _ = kernel_fwd(q, k, v, window=window, passes=1)
    plain = ref.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), window=window)
    assert not np.allclose(one, plain.numpy(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("d", sorted(TILING))
@pytest.mark.parametrize("window", [None, 1, 37, 100, 190])
def test_each_visible_pair_is_computed_once(d, window):
    """Each (q head, row, key) pair a row sees lies in exactly one tile that
    a consumer computes over that row, each computed tile holds a pair the
    consumer's rows see, and each tile computed without masks holds only
    such pairs; GQA 5:1 over 2 batch rows. The lengths put a tile's corner
    on the diagonal and on the window's edge besides the ragged ends."""
    for sq, skv in ((1, 1), (1, 191), (65, 65), (65, 200), (191, 150), (129, 255),
                    (130, 193), (300, 700)):
        vis = _visible(sq, skv, window)
        b, hq, hkv, bkv = 2, 5, 1, TILING[d]["BKV"]
        count = np.zeros((b * hq, sq, skv), np.int32)
        for _, bh, _, _, r0, tiles in schedule(b, hq, hkv, sq, skv, d, window):
            for _, kb, edge in tiles:
                tile = vis[r0:r0 + 64, kb:kb + bkv]
                assert tile.any(), (sq, skv, r0, kb)
                assert edge or (tile.shape[1] == bkv and tile.all()), (sq, skv, r0, kb)
                count[bh, r0:r0 + 64, kb:kb + bkv] += tile
        assert (count == vis[None]).all(), (d, window, sq, skv)


@pytest.mark.parametrize("batch,hq,hkv,s,d,window", [(2, 32, 8, 2048, 80, None),
                                                     (8, 32, 8, 2048, 80, None),
                                                     (2, 16, 8, 2048, 240, None),
                                                     (2, 16, 8, 2048, 240, 1024),
                                                     (3, 5, 1, 300, 128, 100)])
def test_grid_covers_every_block_once_longest_first(batch, hq, hkv, s, d, window):
    """The grid's order maps one to one onto the (head, q block) pairs; each
    group holds whole kv groups; without a window the key tiles a block
    walks never grow within a group: longest first."""
    bhs, bq = batch * hq, _bq(d)
    group = group_of(batch, hq, hkv, s, d)
    assert group % (hq // hkv) == 0
    order = [block_at(x, group, bhs, hq, hkv, s, s, window, d)
             for x in range(bhs * -(-s // bq))]
    assert sorted((bh, q0) for bh, q0, _, _, _ in order) == [
        (bh, qb * bq) for bh in range(bhs) for qb in range(-(-s // bq))]
    if window is None:
        per_group = -(-s // bq) * group
        for g0 in range(0, len(order), per_group):
            lengths = [n for _, _, _, _, n in order[g0:g0 + per_group]]
            assert lengths == sorted(lengths, reverse=True)
