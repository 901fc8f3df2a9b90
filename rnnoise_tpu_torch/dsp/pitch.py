"""Batched open-loop pitch analysis — the counterpart of
``rnnoise_tpu/dsp/pitch.py`` (reference src/pitch.c, src/celt_lpc.c).

  * 2x decimation + LPC whitening   (rnn_pitch_downsample, pitch.c:146-214)
  * order-4 Levinson-Durbin with the 30 dB early-out as masking
                                    (celt_lpc.c:38-174)
  * coarse 4x / fine 2x correlation search with find_best_pitch's dual-best
    ranking                         (pitch.c:44-102, 281-385)
  * rnn_remove_doubling's sub-multiple ladder (pitch.c:422-528), unrolled.

Per-lag correlations are grouped convolutions (one group per stream), or
the lag-correlation kernel of ``cuda_xcorr.py`` for the fine table;
per-stream lookups are ``torch.gather``.  The sums that decide a period
(the autocorrelations of the LPC fit, the coarse correlations, every
window energy, and the fine lag table where a kernel or its plain version
computes it) add products of two floats, which are exact in f64, in f64
and round once to f32, so the whole-chunk kernel (``csrc/frame.cu``), which
sums them in its own order, makes the same decisions.  The fused analysis kernel
(``cuda_analysis.py``) replaces the fine search and the ladder, which its
plain version runs from here.  Ranking sits on ~1e-4 knife edges, so
nothing here may run in TF32 (see ``config.resolve_device``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as Fn

from ..config import (PITCH_BUF_SIZE, PITCH_FRAME_SIZE, PITCH_MAX_PERIOD,
                      PITCH_MIN_PERIOD)
from . import cuda_xcorr

_DS_LEN = PITCH_BUF_SIZE // 2          # 864
_X_OFF = PITCH_MAX_PERIOD // 2         # 384
_N2 = PITCH_FRAME_SIZE // 2            # 480
_MAXP2 = PITCH_MAX_PERIOD // 2         # 384
_MINP2 = PITCH_MIN_PERIOD // 2         # 30
_MAX_PITCH = PITCH_MAX_PERIOD - 3 * PITCH_MIN_PERIOD   # 588
FINE_LAGS = _MAX_PITCH // 2            # 294

_SECOND_CHECK = (0, 0, 3, 2, 3, 2, 5, 2, 3, 2, 3, 2, 5, 2, 3, 2)


def batched_xcorr(x: torch.Tensor, y: torch.Tensor, nlags: int) -> torch.Tensor:
    """xc[s, i] = sum_j x[s, j] * y[s, i + j] for i < nlags.

    x: [S, K], y: [S, >= nlags + K - 1].  One grouped conv, a filter per
    stream."""
    S, K = x.shape
    return Fn.conv1d(y[None, :, :nlags + K - 1], x[:, None, :], groups=S)[0]


def window_energy(y: torch.Tensor, length: int, nlags: int) -> torch.Tensor:
    """e[s, i] = sum_{j<length} y[s, i+j]^2 for i < nlags, summed in f64 and
    rounded once to f32."""
    d2 = y.double().square()[:, None, :length + nlags - 1]
    ones = torch.ones((1, 1, length), dtype=torch.float64, device=y.device)
    return Fn.conv1d(d2, ones)[:, 0].float()


def _sliding_syy(y: torch.Tensor, length: int, nlags: int) -> torch.Tensor:
    """Syy[s, i] = 1 + sum_{j<length} y[s, i+j]^2, clamped >= 1
    (find_best_pitch's running denominator, pitch.c:67-100)."""
    return torch.clamp(1.0 + window_energy(y, length, nlags), min=1.0)


def find_best_pitch(xcorr: torch.Tensor, syy: torch.Tensor):
    """Top-2 lags ranked by xcorr^2 / Syy over lags with xcorr > 0, with the
    reference's initial candidates (0, 1) when fewer than two lags qualify
    (pitch.c:61-66)."""
    num = torch.square(xcorr * 1e-12)
    mask = xcorr > 0
    neg_inf = torch.full_like(num, float("-inf"))
    q = torch.where(mask, num / syy, neg_inf)
    i0 = torch.argmax(q, dim=-1)
    q2 = q.scatter(1, i0[:, None], float("-inf"))
    i1 = torch.argmax(q2, dim=-1)
    count = mask.sum(dim=-1)
    i0 = torch.where(count >= 1, i0, 0)
    i1 = torch.where(count >= 2, i1, torch.where(count == 1, 0, 1))
    return i0.int(), i1.int()


def find_best_pitch_exact(xcorr: torch.Tensor, y: torch.Tensor, length: int):
    """find_best_pitch as the reference runs it (pitch.c:44-102, float
    build): the running energy ``Syy = max(1, (Syy + y[i+len]^2) - y[i]^2)``
    from a left-to-right f32 sum, and the cross-multiplied top-2 comparisons
    ``num * best_den > best_num * Syy`` (strict, so earlier lags win ties)
    instead of the ratio ranking, whose division rounds differently in
    near-ties.  One step per lag: a parity tool, not the serving path
    (RuntimeConfig.exact_pitch_rank)."""
    nlags = xcorr.shape[-1]
    y2 = y * y
    syy = torch.ones_like(y[:, 0])
    for j in range(length):
        syy = syy + y2[:, j]
    num0 = torch.full_like(syy, -1.0)
    den0 = torch.zeros_like(syy)
    i0 = torch.zeros_like(syy, dtype=torch.int32)
    num1, den1, i1 = num0, den0, torch.ones_like(i0)
    for i in range(nlags):
        xc = xcorr[:, i]
        num = torch.square(xc * 1e-12)
        beats1 = (xc > 0) & (num * den1 > num1 * syy)
        # the slot-0 comparison only happens inside the slot-1 branch
        # (pitch.c:83-97)
        beats0 = beats1 & (num * den0 > num0 * syy)
        num1 = torch.where(beats0, num0, torch.where(beats1, num, num1))
        den1 = torch.where(beats0, den0, torch.where(beats1, syy, den1))
        i1 = torch.where(beats0, i0, torch.where(beats1, i, i1))
        num0 = torch.where(beats0, num, num0)
        den0 = torch.where(beats0, syy, den0)
        i0 = torch.where(beats0, i, i0)
        syy = torch.clamp((syy + y2[:, i + length]) - y2[:, i], min=1.0)
    return i0.int(), i1.int()


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a: [S, L]; idx: [S] or [S, M] -> a[s, idx[s, ...]]."""
    if idx.ndim == 1:
        return torch.gather(a, 1, idx.long()[:, None])[:, 0]
    return torch.gather(a, 1, idx.long())


def pitch_downsample(pitch_buf: torch.Tensor) -> torch.Tensor:
    """[S, 1728] -> [S, 864] decimated + LPC-whitened
    (rnn_pitch_downsample, pitch.c:146-214)."""
    x = pitch_buf.float()
    # x_lp[i] = .25*(x[2i-1] + x[2i+1]) + .5*x[2i]; i = 0 has no left tap
    xl = Fn.pad(x[:, :-1], (1, 0))
    xr = Fn.pad(x[:, 1:], (0, 1))
    x_lp = (0.25 * (xl + xr) + 0.5 * x)[:, 0::2]
    x_lp = torch.cat([(0.25 * x[:, 1] + 0.5 * x[:, 0])[:, None],
                      x_lp[:, 1:]], dim=-1)

    n = _DS_LEN
    xd = x_lp.double()
    ac = [(xd[:, :n - k] * xd[:, k:]).sum(dim=-1).float() for k in range(5)]
    ac[0] = ac[0] * 1.0001
    for i in range(1, 5):
        ac[i] = ac[i] - ac[i] * (0.008 * i) ** 2     # lag windowing

    lpc = _levinson4(ac)
    tmp = 1.0
    for i in range(4):                               # .9^i damping
        tmp *= 0.9
        lpc[i] = lpc[i] * tmp

    c1 = 0.8
    num = [lpc[0] + c1, lpc[1] + c1 * lpc[0], lpc[2] + c1 * lpc[1],
           lpc[3] + c1 * lpc[2], c1 * lpc[3]]
    # celt_fir5 (pitch.c:104-143): y[i] = x[i] + sum_k num[k] * x[i-1-k]
    y = x_lp
    for k in range(5):
        shifted = Fn.pad(x_lp, (k + 1, 0))[:, :n]
        y = y + num[k][:, None] * shifted
    return y


def _levinson4(ac):
    """Order-4 Levinson-Durbin with the 30 dB early-out as masking
    (rnn_lpc, celt_lpc.c:38-89)."""
    ac0 = ac[0]
    lpc = [torch.zeros_like(ac0) for _ in range(4)]
    error = ac0
    done = ac0 == 0.0
    for i in range(4):
        rr = ac[i + 1]
        for j in range(i):
            rr = rr + lpc[j] * ac[i - j]
        r = -rr / torch.where(done, torch.ones_like(error), error)
        new = list(lpc)
        new[i] = r
        for j in range((i + 1) // 2):
            t1, t2 = lpc[j], lpc[i - 1 - j]
            new[j] = t1 + r * t2
            new[i - 1 - j] = t2 + r * t1
        lpc = [torch.where(done, o, nv) for o, nv in zip(lpc, new)]
        error = torch.where(done, error, error - r * r * error)
        done = done | (error < 0.001 * ac0)
    return lpc


def lag_corr_table(x_lp: torch.Tensor, xcorr: bool = False,
                   plain: bool = False) -> torch.Tensor:
    """bx[s, i] = sum_{j<480} x_lp[s, 384+j] * x_lp[s, i+j] for i = 0..384:
    the fine search's cross-correlations (lags 0..293) and remove_doubling's
    lag-t products (bx[384 - t]) in one table.

    ``xcorr`` (RuntimeConfig.xcorr) takes the table from the lag-correlation
    kernel (its plain version when ``plain``), both summed in f64; otherwise
    it is one grouped f32 convolution."""
    if xcorr:
        return (cuda_xcorr.lag_corr_table_plain if plain
                else cuda_xcorr.lag_corr_table_kernel)(x_lp)
    return batched_xcorr(x_lp[:, _X_OFF:_X_OFF + _N2], x_lp, _MAXP2 + 1)


def coarse_search(x_lp: torch.Tensor, exact_rank: bool = False):
    """The 4x-decimated coarse stage of rnn_pitch_search (pitch.c:322-340):
    the top-2 coarse lags (bp0, bp1), [S] int32.  The correlations sum in
    f64 and round once; ``exact_rank`` ranks with find_best_pitch_exact."""
    len4 = _N2 // 2                                  # 240
    nl4 = _MAX_PITCH // 4                            # 147
    x4 = x_lp[:, _X_OFF::2][:, :len4]
    y4 = x_lp[:, 0:2 * ((_N2 * 2 + _MAX_PITCH) // 4):2]   # [S, 387]
    xc4 = batched_xcorr(x4.double(), y4.double(), nl4).float()
    if exact_rank:
        return find_best_pitch_exact(xc4, y4, len4)
    return find_best_pitch(xc4, _sliding_syy(y4, len4, nl4))


def fine_search(bx: torch.Tensor, syy: Optional[torch.Tensor],
                bp0: torch.Tensor, bp1: torch.Tensor,
                exact_y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The 2x-decimated fine stage of rnn_pitch_search (pitch.c:342-384):
    bx the lag table, syy [S, 294] the ranking's denominators (1 + the lag
    windows' energies, clamped >= 1), bp0/bp1 the coarse lags; with
    ``exact_y`` (the whitened buffer) the ranking is find_best_pitch_exact
    on its running energies instead, and syy is not read.  Returns
    ``pitch`` in 48 kHz samples before the 768-minus flip."""
    nl2 = FINE_LAGS
    # fine search, 2x decimated, within 2 lags of 2*best
    lags = torch.arange(nl2, device=bx.device, dtype=torch.int32)[None, :]
    cand = ((lags - 2 * bp0[:, None]).abs() <= 2) | \
           ((lags - 2 * bp1[:, None]).abs() <= 2)
    xc2 = torch.where(cand, torch.clamp(bx[:, :nl2], min=-1.0),
                      torch.zeros_like(bx[:, :nl2]))
    fb0, _ = (find_best_pitch(xc2, syy) if exact_y is None
              else find_best_pitch_exact(xc2, exact_y, _N2))
    # pseudo-interpolation (pitch.c:368-384)
    a = _take(xc2, torch.clamp(fb0 - 1, min=0))
    b = _take(xc2, fb0)
    c = _take(xc2, torch.clamp(fb0 + 1, max=nl2 - 1))
    offset = torch.where((c - a) > 0.7 * (b - a), 1,
                         torch.where((a - c) > 0.7 * (b - c), -1, 0))
    interior = (fb0 > 0) & (fb0 < nl2 - 1)
    offset = torch.where(interior, offset, 0)
    return (2 * fb0 - offset).int()


def pitch_search(x_lp: torch.Tensor, bx: torch.Tensor,
                 exact_rank: bool = False) -> torch.Tensor:
    """x_lp: [S, 864] whitened, decimated pitch buffer; bx its lag table.

    Returns ``pitch`` in 48 kHz samples before the 768-minus flip, as
    rnn_pitch_search writes it (pitch.c:281-385) for (x_lp+384, x_lp, 960,
    588).  ``exact_rank`` ranks both stages with find_best_pitch_exact."""
    bp0, bp1 = coarse_search(x_lp, exact_rank)
    if exact_rank:
        return fine_search(bx, None, bp0, bp1, exact_y=x_lp)
    return fine_search(bx, _sliding_syy(x_lp, _N2, FINE_LAGS), bp0, bp1)


def _pitch_gain(xy, xx, yy):
    return xy / torch.sqrt(1.0 + xx * yy)


def remove_doubling(x_lp: torch.Tensor, pitch_index: torch.Tensor,
                    prev_period: torch.Tensor, prev_gain: torch.Tensor,
                    bx: torch.Tensor, yy: Optional[torch.Tensor] = None):
    """Batched rnn_remove_doubling (pitch.c:422-528).

    x_lp: [S, 864]; pitch_index, prev_period: [S] int32 in 48 kHz units;
    prev_gain: [S]; bx: the lag table; yy: [S, 385] the energies of the
    480-sample windows at each table entry (computed from x_lp when
    None).  Every candidate's 480-tap product and energy is a lookup.
    Returns (new_pitch_index [S] int32, gain [S])."""
    T0 = torch.clamp(pitch_index // 2, max=_MAXP2 - 1).int()
    prev_period = (prev_period // 2).int()
    dev = x_lp.device

    xx = bx[:, _MAXP2]                                # lag 0
    xy = _take(bx, _MAXP2 - T0)
    # yy_rev[u] = energy of the lag-(384-u) window
    yy_rev = window_energy(x_lp, _N2, _MAXP2 + 1) if yy is None else yy
    yy = _take(yy_rev, _MAXP2 - T0)
    best_xy, best_yy = xy, yy
    g0 = _pitch_gain(xy, xx, yy)
    g = g0
    T = T0

    # every candidate sub-period depends only on (T0, k): look the whole
    # k = 2..15 ladder up at once
    ks = torch.arange(2, 16, dtype=torch.int32, device=dev)[None, :]
    T1s = (2 * T0[:, None] + ks) // (2 * ks)                    # [S, 14]
    sc = torch.tensor(_SECOND_CHECK[2:], dtype=torch.int32, device=dev)[None, :]
    T1bs = (2 * sc * T0[:, None] + ks) // (2 * ks)
    first = torch.where(T1s[:, 0] + T0 > _MAXP2, T0, T0 + T1s[:, 0])
    T1bs = torch.cat([first[:, None], T1bs[:, 1:]], dim=1)
    xy1s = _take(bx, _MAXP2 - T1s)
    xy2s = _take(bx, _MAXP2 - T1bs)
    yy1s = _take(yy_rev, _MAXP2 - T1s)
    yy2s = _take(yy_rev, _MAXP2 - T1bs)

    active = torch.ones_like(T0, dtype=torch.bool)
    zero = torch.zeros_like(prev_gain)
    for k in range(2, 16):
        j = k - 2
        T1 = T1s[:, j]
        active = active & (T1 >= _MINP2)              # `break` (pitch.c:469-470)
        xy_k = 0.5 * (xy1s[:, j] + xy2s[:, j])
        yy_k = 0.5 * (yy1s[:, j] + yy2s[:, j])
        g1 = _pitch_gain(xy_k, xx, yy_k)
        d = (T1 - prev_period).abs()
        cont = torch.where(d <= 1, prev_gain,
                           torch.where((d <= 2) & (5 * k * k < T0),
                                       0.5 * prev_gain, zero))
        thresh = torch.clamp(0.7 * g0 - cont, min=0.3)
        # the reference's `else if (T1 < 2*minperiod)` branch is dead code
        # (subsumed by T1 < 3*minperiod, pitch.c:494-498)
        thresh = torch.where(T1 < 3 * _MINP2,
                             torch.clamp(0.85 * g0 - cont, min=0.4), thresh)
        take = active & (g1 > thresh)
        best_xy = torch.where(take, xy_k, best_xy)
        best_yy = torch.where(take, yy_k, best_yy)
        T = torch.where(take, T1, T)
        g = torch.where(take, g1, g)

    best_xy = torch.clamp(best_xy, min=0.0)
    pg = torch.where(best_yy <= best_xy, torch.ones_like(best_xy),
                     best_xy / (best_yy + 1.0))
    lags3 = torch.clamp(T[:, None] + torch.arange(-1, 2, device=dev)[None, :],
                        0, _MAXP2)
    xc = _take(bx, _MAXP2 - lags3)
    offset = torch.where((xc[:, 2] - xc[:, 0]) > 0.7 * (xc[:, 1] - xc[:, 0]), 1,
                         torch.where((xc[:, 0] - xc[:, 2])
                                     > 0.7 * (xc[:, 1] - xc[:, 2]), -1, 0))
    pg = torch.minimum(pg, g)
    T0_out = torch.clamp(2 * T + offset, min=PITCH_MIN_PERIOD).int()
    return T0_out, pg
