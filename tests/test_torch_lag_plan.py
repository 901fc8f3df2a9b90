"""The plan of the analysis' lag table and energies on the f64 tensor cores
(``csrc/analysis_body.cuh``: ``lag_energy_mma``), on CPU.

The tiles run only on the card.  Their plan lives in ``dsp/cuda_xcorr.py``
(``lag_mma_tiles``); here numpy builds each tile's A and B fragments from
that plan, checks that every (lag, tap) product of the table appears
exactly once and every product outside the band is a zero, and runs the
chain of m8n8k4 products in f64, rounded once to f32, against the plain
versions (``lag_corr_table_plain``, ``pitch.window_energy``).
"""

import os
import re

import numpy as np
import pytest
import torch

from rnnoise_tpu_torch import kernels
from rnnoise_tpu_torch.dsp import cuda_analysis, cuda_xcorr, pitch

X = cuda_xcorr


def _source(name):
    with open(os.path.join(kernels.CSRC_DIR, name)) as f:
        return f.read()


def _ulps(a, b):
    """|a - b| in f32 ulps, elementwise."""
    def key(x):
        i = np.ascontiguousarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(key(a) - key(b))


def emulate_lag_energy(ds):
    """(bx, yy) [S, 385] f32 of ds [S, 864] as the tiles compute them: per
    tile, the sum over the k-steps in order of the step's 16 x 8 by 8 x 8
    product in f64 (A from ds, B from x or its 0/1 band, as the plan gives
    them), rounded once; lag 384 the sum of x^2."""
    a_idx, lag, tap, band = X.lag_mma_tiles()
    d = ds.astype(np.float64)
    S = d.shape[0]
    x = d[:, X.X_OFF:]
    A = d[:, a_idx[..., 0]]                                     # [S, q, m, row, k]
    tb, bb = tap[:, :, 0], band[:, :, 0]                        # [q, m, k, n]
    B = np.where(bb, x[:, np.clip(tb, 0, X.CORR_LEN - 1)], 0.0)
    E = bb.astype(np.float64)
    acc = np.zeros((S, X.MMA_TILES, X.MMA_M, X.MMA_N))
    en = np.zeros_like(acc)
    for m in range(X.MMA_KSTEPS):
        acc = acc + np.einsum("sqgk,sqkn->sqgn", A[:, :, m], B[:, :, m])
        en = en + np.einsum("sqgk,qkn->sqgn", A[:, :, m] ** 2, E[:, m])
    bx = np.empty((S, X.N_LAGS))
    yy = np.empty((S, X.N_LAGS))
    out = lag[:, 0, :, 0, :]                                    # [q, row, n]
    bx[:, out] = acc
    yy[:, out] = en
    bx[:, -1] = yy[:, -1] = (x * x).sum(1)
    return bx.astype(np.float32), yy.astype(np.float32)


def test_plan_constants_match_kernel_source():
    src = _source("analysis_body.cuh")
    m = re.search(r"MMA_M = (\d+), MMA_N = (\d+), MMA_K = (\d+);", src)
    assert tuple(int(v) for v in m.groups()) == (X.MMA_M, X.MMA_N, X.MMA_K)
    assert int(re.search(r"LAG_WARPS = (\d+);", src).group(1)) == X.LAG_WARPS
    for name, expr in (("MMA_TILE_LAGS", "MMA_M * MMA_N"),
                       ("MMA_TILES", "(NLAGS - 1) / MMA_TILE_LAGS"),
                       ("MMA_K_LEN", "N2 + (MMA_N - 1) * MMA_M"),
                       ("MMA_KSTEPS", "MMA_K_LEN / MMA_K")):
        assert f"constexpr int {name} = {expr};" in src, name
    assert "MMA_DS_EXTENT = (MMA_TILES - 1) * MMA_TILE_LAGS + MMA_M - 1 + MMA_K_LEN;" in src
    assert (X.MMA_TILES, X.MMA_KSTEPS, X.MMA_DS_EXTENT) == (3, 74, 863)
    # the product is the m16n8k8 f64 shape whose fragments lag_mma_lanes lays out
    assert "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64" in src
    frame = _source("frame.cu")
    assert "lag_energy_mma<LAG_WARPS>(ns, aw.ds64, DSTR," in frame
    assert "lag_energy_mma<LAG_WARPS>(ns, sm.lag.ds[0], DS," in _source("analysis.cu")


def test_tiles_hold_each_product_once_and_zeros_outside_the_band():
    """Every (lag <= 383, tap < 480) product comes from exactly one tile,
    k-step, row and column, as ds[lag + tap] x[tap]; lag 384 is the
    separate sum; every other product has B = 0 (and E = 0); no tile reads
    past ds[862], so a stream's reads stay inside its own 864 values."""
    a_idx, lag, tap, band = X.lag_mma_tiles()
    seen = np.zeros((X.N_LAGS, X.CORR_LEN), np.int64)
    np.add.at(seen, (lag[band], tap[band]), 1)
    assert (seen[:-1] == 1).all() and (seen[-1] == 0).all()
    assert (a_idx[band] == lag[band] + tap[band]).all()
    assert a_idx.min() == 0 and a_idx.max() == X.MMA_DS_EXTENT - 1 < X.DS_LEN
    # outside the band, the fragment B (and E) is zero: the product vanishes
    rng = np.random.default_rng(3)
    x = rng.standard_normal(X.CORR_LEN)
    B = np.where(band, x[np.clip(tap, 0, X.CORR_LEN - 1)], 0.0)
    assert (B[~band] == 0).all() and (~band).any()
    # each tile's outputs: the 128 lags L0 .. L0 + 127, one a row and column
    for q in range(X.MMA_TILES):
        assert sorted(lag[q, 0, :, 0, :].ravel()) == list(range(q * 128, q * 128 + 128))


def test_lane_fragments_are_the_products_elements():
    """The kernel's sliding window of ds, its reads of x and its stores of C
    hold, lane by lane, the elements the m16n8k8 f64 product takes and gives
    there (the fragment layout checked on the card): A[row][k] of step m is
    ds[L0 + row + 8m + k], B[k][n] is x[8m + k - 16n], C[row][n] is lag
    L0 + row + 16n; the lanes hold each element of A, B and C once."""
    a_off, a_rc, b_off, b_rc, c_lag, c_rc = X.lag_mma_lanes()
    assert (a_off == a_rc[..., 0] + a_rc[..., 1]).all()
    assert (b_off == b_rc[..., 0] - X.MMA_M * b_rc[..., 1]).all()
    assert (c_lag == c_rc[..., 0] + X.MMA_M * c_rc[..., 1]).all()
    for rc, shape in ((a_rc, (X.MMA_M, X.MMA_K)), (b_rc, (X.MMA_K, X.MMA_N)),
                      (c_rc, (X.MMA_M, X.MMA_N))):
        n = np.zeros(shape, np.int64)
        np.add.at(n, (rc[..., 0], rc[..., 1]), 1)
        assert (n == 1).all()
    # rows g + 8 of step m are rows g of step m + 1: the window's second
    # values are its first values one step on
    assert (a_off[:, 1] == a_off[:, 0] + X.MMA_K).all()
    assert (a_off[:, 3] == a_off[:, 2] + X.MMA_K).all()
    src = _source("analysis_body.cuh")
    assert "dmma_m16n8k8(cb[q], u[q][0], u[q][1], v[q][0], v[q][1], b0, b1);" in src
    assert "const int i = q * MMA_TILE_LAGS + g + 2 * MMA_M * t;" in src
    assert "const int at = i + MMA_M * (c & 1) + 8 * (c >> 1);" in src


def _inputs():
    """ds [6, 864] f32: noise, speech-like tones, a near-silent stream, one
    whose energy falls 1e6x across the buffer, one with a loud start and a
    near-silent end, and zeros."""
    rng = np.random.default_rng(21)
    n = np.arange(X.DS_LEN)
    tone = sum(np.sin(2 * np.pi * 0.013 * k * n + rng.uniform(0, 6)) / k for k in range(1, 8))
    ds = np.stack([
        300 * rng.standard_normal(X.DS_LEN),
        3000 * tone + 30 * rng.standard_normal(X.DS_LEN),
        0.03 * rng.standard_normal(X.DS_LEN),
        300 * rng.standard_normal(X.DS_LEN) * 10.0 ** (-3.0 * n / (X.DS_LEN - 1)),
        np.where(n < 300, 3000.0, 1e-3) * rng.standard_normal(X.DS_LEN),
        np.zeros(X.DS_LEN),
    ])
    return ds.astype(np.float32)


def test_tiled_sum_matches_plain_versions():
    """The tiles' f64 sums, rounded once, are the plain versions' (f64
    convolutions rounded once) but for the order of the f64 additions: at
    most 1 ulp apart, and equal in nearly every value."""
    ds = _inputs()
    bx, yy = emulate_lag_energy(ds)
    pbx, pyy = (t.numpy() for t in cuda_analysis.lag_energy_table_plain(torch.from_numpy(ds)))
    assert np.array_equal(pyy, pitch.window_energy(torch.from_numpy(ds), X.CORR_LEN,
                                                   X.N_LAGS).numpy())
    for got, want in ((bx, pbx), (yy, pyy)):
        u = _ulps(got, want)
        assert int(u.max()) <= 1
        assert (u > 0).mean() <= 1e-3
    assert not bx[-1].any() and not yy[-1].any()           # silence gives zeros


@pytest.mark.parametrize("row", [3, 4])
def test_energies_keep_their_own_scale(row):
    """Where the buffer's energy falls 1e6x, or from loud to near-silent,
    each energy is its own window's sum: the late lags' small energies are
    not swamped by the early ones (relative error at the f32 rounding)."""
    ds = _inputs()[row:row + 1]
    _, yy = emulate_lag_energy(ds)
    d = ds[0].astype(np.float64)
    exact = np.array([np.dot(d[i:i + X.CORR_LEN], d[i:i + X.CORR_LEN])
                      for i in range(X.N_LAGS)])
    assert exact.max() / exact.min() > 100
    assert float((np.abs(yy[0] - exact) / exact).max()) <= 1.0001 * 2 ** -24


def test_lag_mma_op_count():
    """444 m16n8k8 products a stream (1024 multiply-adds each), a quarter
    more than the table's and energies' 2 x 384 x 480 useful ones (the
    band's zeros), and few operations on the f64 pipe beside them."""
    mma, vec = X.lag_mma_ops()
    assert mma == 2 * 3 * 74 * 1024 == 444 * 1024
    assert 1.2 < mma / (2 * 384 * 480) < 1.25
    assert vec < mma / 25
