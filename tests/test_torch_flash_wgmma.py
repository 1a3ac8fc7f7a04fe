"""The arithmetic and schedule of the bf16 ``flash_attention`` forward, on the CPU.

The kernel (``src/repro_torch/kernels/csrc/flash_attention_tc.cu``) runs on
Hopper with wgmma and TMA: a block owns BQ query rows of one (batch, q head)
in two consumer warpgroups of 64 rows; it loads the key tiles of BKV keys from
the first one any of its rows may see to the last, and each warpgroup runs
the products of the tiles its own rows may see, masking only the tiles that
cross its diagonal, its window edge or the end of the keys. The online
softmax runs in log2 units with the scale folded into the exponent; P is
rounded to bf16 before P V, the row sum l is taken over the rounded P and the
log-sum-exp over P before rounding. The grid walks groups of heads, each
group's query blocks longest first.

Here that schedule is walked tile by tile in numpy, with BQ, BKV and the L2
budget of the head groups read from the ``.cu`` source, so the emulation
cannot drift from the kernel's tiling. It is held against the port's plain
version (``ref.flash_attention`` and ``ref.flash_attention_lse``) and the JAX
package's oracle (``repro.kernels.ref.flash_attention``, kv heads repeated),
and its Pallas kernel (``ops.mha(interpret=True)``) where that is right
(``tests/test_torch_flash.py``): within 2e-2 with P rounded to bf16, as the
CUDA tests hold the kernel, and within 1e-5 in f32 with P left unrounded,
which checks the tile schedule, the masks and the online softmax apart from
the rounding. The log-sum-exp within 1e-5 either way.
"""
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import ref

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
          / "flash_attention_tc.cu").read_text()
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def _constexpr(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


BQ = _constexpr("BQ")
WG_ROWS = BQ // _constexpr("CONSUMERS")
TILING = {int(d): (int(bkv), int(st)) for d, bkv, st in re.findall(
    r"struct Tiling<(\d+)> \{ static constexpr int BKV = (\d+), STAGES = (\d+); \};", SOURCE)}
_L2 = re.search(r"constexpr size_t L2_KV_BYTES = (\d+)u << (\d+);", SOURCE)
L2_KV_BYTES = int(_L2.group(1)) << int(_L2.group(2))


def test_source_constants():
    """The tiling the emulation reads is the kernel's: two 64-row warpgroups,
    one entry per head dim of the wrapper, tiles of whole k-steps of 16."""
    assert (BQ, WG_ROWS) == (128, 64)
    assert sorted(TILING) == sorted(kflash.HEAD_DIMS)
    assert all(bkv % 16 == 0 and stages >= 2 for bkv, stages in TILING.values())
    assert L2_KV_BYTES > 0


# -- the kernel's index arithmetic, line for line -------------------------------

def block_tiles(q0, sq, skv, window, bkv):
    """(kb0, n_tiles): the key tiles a block of rows [q0, q0 + BQ) loads."""
    off = skv - sq
    k_hi = min(skv, min(q0 + BQ, sq) + off) - 1
    k_lo = max(0, q0 + off - window + 1) if window else 0
    kb0 = (k_lo // bkv) * bkv
    return kb0, ((k_hi - kb0) // bkv + 1 if k_hi >= kb0 else 0)


def wg_tiles(r0, sq, skv, window, bkv, kb0, n_tiles):
    """[j_lo, j_hi): the tiles of the block a warpgroup of rows [r0, r0 + 64)
    runs products on."""
    if r0 >= sq or n_tiles <= 0:
        return 0, 0
    qpos0 = r0 + skv - sq
    k_last = qpos0 + WG_ROWS - 1
    k_first = qpos0 - window + 1 if window else 0
    j_hi = min(n_tiles, (k_last - kb0) // bkv + 1) if k_last >= kb0 else 0
    j_lo = (k_first - kb0) // bkv if k_first > kb0 else 0
    return (0, 0) if j_lo >= j_hi else (j_lo, j_hi)


def edge(kb, qpos0, skv, window, bkv):
    """Whether a tile's scores need masks for a warpgroup whose first row sits
    at key position qpos0."""
    return (kb + bkv - 1 > qpos0 or kb + bkv > skv
            or (bool(window) and kb <= qpos0 + WG_ROWS - 1 - window))


def head_group(batch, hq, hkv, skv, d):
    """Heads (b * hq + h) per group of the grid, as the host computes it."""
    fit = L2_KV_BYTES // (4 * max(skv, 1) * d)
    return (1 if fit < 1 else min(fit, batch * hkv)) * (hq // hkv)


def block_of(x, bhs, nqb, group):
    """(bh, qb) of linear block x, as the kernel computes it."""
    g0 = x // (group * nqb) * group
    gs = min(group, bhs - g0)
    within = x - g0 * nqb
    return g0 + within % gs, nqb - 1 - within // gs


def _visible(sq, skv, window):
    qpos = np.arange(sq)[:, None] + skv - sq
    kpos = np.arange(skv)[None, :]
    keep = kpos <= qpos
    if window:
        keep &= kpos > qpos - window
    return keep


# -- the emulation ----------------------------------------------------------------

def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).bfloat16().float().numpy()


def _f32(x):
    return np.asarray(x, dtype=np.float64).astype(np.float32)


def kernel_head(q, k, v, *, window=None, scale=None, round_p=True):
    """The kernel's output and log-sum-exp for one head: q [Sq, D], k, v
    [Skv, D] float32. Products of the tensor cores are summed in float64 and
    rounded to f32 once per product, as their f32 accumulation allows."""
    sq, d = q.shape
    skv = k.shape[0]
    bkv = TILING[d][0]
    sl2 = np.float32(np.float32(scale if scale is not None else 1.0 / math.sqrt(d))
                     * np.float32(LOG2E))
    out = np.zeros((sq, d), np.float32)
    lse = np.full(sq, -np.inf, np.float32)
    for q0 in range(0, sq, BQ):
        kb0, n_tiles = block_tiles(q0, sq, skv, window, bkv)
        for r0 in range(q0, q0 + BQ, WG_ROWS):
            j_lo, j_hi = wg_tiles(r0, sq, skv, window, bkv, kb0, n_tiles)
            rows = slice(r0, min(r0 + WG_ROWS, sq))
            if rows.start >= rows.stop:
                continue
            qpos0 = r0 + skv - sq
            qpos = np.arange(rows.start, rows.stop) + skv - sq
            m = np.full(rows.stop - rows.start, -np.inf, np.float32)
            l = np.zeros_like(m)
            le = np.zeros_like(m)
            o = np.zeros((rows.stop - rows.start, d), np.float32)
            for j in range(j_lo, j_hi):
                kb = kb0 + j * bkv
                kt = np.zeros((bkv, d), np.float32)      # rows past Skv arrive as zeros
                vt = np.zeros((bkv, d), np.float32)
                kt[:max(0, min(bkv, skv - kb))] = k[kb:kb + bkv]
                vt[:max(0, min(bkv, skv - kb))] = v[kb:kb + bkv]
                s = _f32(q[rows].astype(np.float64) @ kt.T.astype(np.float64))
                kpos = kb + np.arange(bkv)
                keep = (kpos[None] <= qpos[:, None]) & (kpos[None] < skv)
                if window:
                    keep &= kpos[None] > qpos[:, None] - window
                if edge(kb, qpos0, skv, window, bkv):
                    s = np.where(keep, s, np.float32(-np.inf))
                else:                      # an interior tile: every score is visible
                    assert keep.all(), (kb, qpos0)
                mx = s.max(axis=1) * sl2
                m_new = np.fmax(m, mx)
                m_use = np.where(m_new == -np.inf, np.float32(0), m_new).astype(np.float32)
                alpha = np.exp2(m - m_use).astype(np.float32)
                m = m_new
                p = np.exp2(_f32(s.astype(np.float64) * sl2 - m_use[:, None])).astype(np.float32)
                pr = _bf16(p) if round_p else p
                l = (l * alpha + pr.sum(axis=1, dtype=np.float64)).astype(np.float32)
                le = (le * alpha + p.sum(axis=1, dtype=np.float64)).astype(np.float32)
                o = _f32(o.astype(np.float64) * alpha[:, None] + pr.astype(np.float64) @ vt)
            with np.errstate(divide="ignore"):
                inv = np.where(l > 0, np.float32(1) / np.where(l > 0, l, 1), np.float32(0))
                out[rows] = o * inv[:, None]
                lse[rows] = np.where(le == 0, -np.inf,
                                     (m + np.log2(np.where(le > 0, le, 1))) * LN2)
    return out, lse


def kernel_mha(q, k, v, **kw):
    """kernel_head over [B, H, S, D], q head h reading kv head h // G."""
    rep = q.shape[1] // k.shape[1]
    pairs = [[kernel_head(q[b, h], k[b, h // rep], v[b, h // rep], **kw)
              for h in range(q.shape[1])] for b in range(q.shape[0])]
    return (np.stack([np.stack([o for o, _ in row]) for row in pairs]),
            np.stack([np.stack([s for _, s in row]) for row in pairs]))


def _inputs(b, hq, hkv, sq, skv, d, seed, bf16):
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=shape).astype(np.float32)
          for shape in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))]
    return [_bf16(x) for x in xs] if bf16 else xs


def _pallas_is_right(sq, skv):
    """Whether the reference's padding in ``ops.mha`` keeps the end alignment
    (as tests/test_torch_flash.py)."""
    pad = lambda n, m: -(-n // m) * m  # noqa: E731
    return pad(skv, 128) - pad(sq, min(128, max(8, sq))) == skv - sq


# (b, hq, hkv, sq, skv, d, window): every head dim; windows None, 16 and 100;
# GQA 1, 2 and 5; fewer queries than keys, more, and one query; lengths 63,
# 64, 65, 127, 129 and 191 around the warpgroup's 64 rows, the block's 128 and
# the tiles of 64 and 128 keys.
SHAPES = [
    (1, 2, 2, 129, 129, 32, None),
    (1, 4, 2, 191, 191, 64, 16),
    (1, 5, 1, 65, 127, 80, 100),
    (1, 2, 1, 127, 63, 128, None),
    (1, 2, 1, 129, 129, 240, 100),
    (1, 4, 2, 1, 191, 80, None),
    (1, 2, 2, 64, 64, 240, 16),
    (2, 10, 2, 63, 65, 64, None),
    (1, 2, 1, 191, 129, 32, 16),
    (1, 2, 2, 1, 65, 240, None),
]


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,window", SHAPES)
def test_bf16_schedule_matches_references(b, hq, hkv, sq, skv, d, window):
    q, k, v = _inputs(b, hq, hkv, sq, skv, d, seed=sq + skv + d, bf16=True)
    got, lse = kernel_mha(q, k, v, window=window)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    plain = ref.flash_attention(tq, tk, tv, window=window).float().numpy()
    np.testing.assert_allclose(got, plain, atol=2e-2, rtol=2e-2)
    plain_lse = ref.flash_attention_lse(tq, tk, window=window).numpy()
    np.testing.assert_array_equal(np.isinf(lse), np.isinf(plain_lse))
    fin = np.isfinite(plain_lse)
    np.testing.assert_allclose(lse[fin], plain_lse[fin], atol=1e-5, rtol=0)
    rep = hq // hkv
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16)
                  for x in (q, np.repeat(k, rep, 1), np.repeat(v, rep, 1)))
    oracle = jref.flash_attention(jq, jk, jv, causal=True, window=window)
    np.testing.assert_allclose(got, np.asarray(oracle.astype(jnp.float32)), atol=2e-2, rtol=2e-2)
    if sq >= 128 and _pallas_is_right(sq, skv):
        pallas = jops.mha(jq, jk, jv, causal=True, window=window, interpret=True)
        np.testing.assert_allclose(got, np.asarray(pallas.astype(jnp.float32)), atol=2e-2,
                                   rtol=2e-2)
    if sq > skv:                       # rows before key 0 see nothing: exact 0
        assert (got[:, :, :sq - skv] == 0).all()


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,window", SHAPES)
def test_f32_schedule_holds_f32(b, hq, hkv, sq, skv, d, window):
    """P left unrounded: the tile schedule, masks and online softmax alone,
    within 1e-5 of the f32 references."""
    q, k, v = _inputs(b, hq, hkv, sq, skv, d, seed=sq + skv + d + 1, bf16=False)
    got, lse = kernel_mha(q, k, v, window=window, round_p=False)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    np.testing.assert_allclose(got, ref.flash_attention(tq, tk, tv, window=window).numpy(),
                               atol=1e-5, rtol=1e-5)
    plain_lse = ref.flash_attention_lse(tq, tk, window=window).numpy()
    fin = np.isfinite(plain_lse)
    np.testing.assert_array_equal(np.isfinite(lse), fin)
    np.testing.assert_allclose(lse[fin], plain_lse[fin], atol=1e-5, rtol=0)
    rep = hq // hkv
    oracle = jref.flash_attention(jnp.asarray(q), jnp.asarray(np.repeat(k, rep, 1)),
                                  jnp.asarray(np.repeat(v, rep, 1)), causal=True, window=window)
    np.testing.assert_allclose(got, np.asarray(oracle), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("d", sorted(TILING))
@pytest.mark.parametrize("window", [None, 1, 16, 100, 1024])
def test_visited_tiles_are_the_visible_ones(d, window):
    """For every block and warpgroup: each key some row may see lies in a
    visited tile, and each visited tile holds a key some row may see."""
    bkv = TILING[d][0]
    for sq, skv in ((1, 1), (1, 191), (63, 65), (64, 64), (65, 63), (127, 129), (129, 127),
                    (191, 191), (300, 1100), (1100, 300), (2048, 2048)):
        vis = _visible(sq, skv, window)
        for q0 in range(0, sq, BQ):
            kb0, n_tiles = block_tiles(q0, sq, skv, window, bkv)
            tiles = [(kb0 + j * bkv, kb0 + (j + 1) * bkv) for j in range(n_tiles)]
            seen = vis[q0:q0 + BQ].any(axis=0)
            for lo, hi in tiles:
                assert seen[lo:hi].any(), (sq, skv, q0, lo)
            covered = np.zeros(skv, bool)
            for lo, hi in tiles:
                covered[lo:hi] = True
            assert not (seen & ~covered).any(), (sq, skv, q0)
            for r0 in range(q0, q0 + BQ, WG_ROWS):
                j_lo, j_hi = wg_tiles(r0, sq, skv, window, bkv, kb0, n_tiles)
                wg_seen = vis[r0:r0 + WG_ROWS].any(axis=0) if r0 < sq else np.zeros(skv, bool)
                for j in range(j_lo, j_hi):
                    assert wg_seen[tiles[j][0]:tiles[j][1]].any(), (sq, skv, r0, j)
                mine = np.zeros(skv, bool)
                for j in range(j_lo, j_hi):
                    mine[tiles[j][0]:tiles[j][1]] = True
                assert not (wg_seen & ~mine).any(), (sq, skv, r0)


@pytest.mark.parametrize("batch,hq,hkv,sq,d", [(8, 16, 16, 2048, 128), (8, 32, 8, 2048, 128),
                                               (8, 25, 5, 2048, 64), (8, 16, 8, 2048, 240),
                                               (2, 32, 8, 8192, 128), (8, 16, 16, 224, 64),
                                               (3, 5, 1, 300, 80)])
def test_grid_order_covers_every_block_longest_first(batch, hq, hkv, sq, d):
    """The grid's blocks map one to one onto (head, query block); groups hold
    whole kv groups, and within a group the query blocks run longest first."""
    bhs, nqb = batch * hq, -(-sq // BQ)
    group = head_group(batch, hq, hkv, sq, d)
    assert group % (hq // hkv) == 0 and group >= hq // hkv
    seen = [block_of(x, bhs, nqb, group) for x in range(bhs * nqb)]
    assert sorted(seen) == [(bh, qb) for bh in range(bhs) for qb in range(nqb)]
    for x in range(1, bhs * nqb):
        (bh0, qb0), (bh1, qb1) = seen[x - 1], seen[x]
        if bh0 // group == bh1 // group:
            assert qb1 <= qb0
