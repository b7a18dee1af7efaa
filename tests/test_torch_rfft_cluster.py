"""The real FFT kernel's route "cluster" (``csrc/rfft_cluster.cu``) and
its block route's load and unpack numbering (``csrc/rfft.cu``), mirrored
in numpy on the CPU; its plan and routing.

``_cluster_mirror`` follows the cluster kernel rank by rank with the
``.cu``'s index arithmetic: each rank's sample groups (4 samples, two
packed points, a group a thread-slot) and the tile address each lands
at, the n1-point column FFTs with TW, the exchange's two groups of C/2
rounds — every rank's reads of a group from its peers' tiles before any
store of that group, then the stores at their transposed addresses —
the n2-point row FFTs, and the unpack's pairs, each mirror bin Z[m − j]
read from the rank that owns its row.  Driven by complex128 numpy line
FFTs and float64 tables, it must give ``np.fft.rfft`` within 1e-12 of
the peak at every size the route takes and at every cluster size that
fits, and write each tile address of each phase exactly once (and each
bin once).  The block route's mirror checks its groups and bins cover a
launch's tiles and outputs once each, a ragged last block included.
The kernel itself runs on a card only (``tests/test_torch_cuda.py``).
"""

import inspect
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from emspec_torch import kernels_build
from emspec_torch.dsp.kernels import rfft
from emspec_torch.dsp.kernels.rfft import (
    CLUSTER_LOG2C, cluster_plan, factors, rfft_frames, route_of, routes_of)

ROOT = Path(__file__).resolve().parents[1]
CSRC = Path(kernels_build.__file__).parent / "csrc"
SIZES = sorted(CLUSTER_LOG2C)


def _cu_constant(name: str, file: str = "rfft_cluster.cu") -> int:
    m = re.search(rf"constexpr int {name} = (\w+);",
                  (CSRC / file).read_text())
    return int(m.group(1))


HELD = _cu_constant("kCHeld")        # exchange values a thread
PAIRS = _cu_constant("kCPairs")      # unpacked pairs a thread


def _fits(n: int, lc: int) -> bool:
    """The plan exists (``cplan``): C ≤ 16, ≥ 16 rows and columns a CTA,
    128–1024 threads, the shared memory a block may take."""
    p = cluster_plan(n, lc)
    return (1 <= lc <= 4 and p["w"] >= 16 and p["a"] >= 16
            and 128 <= p["threads"] <= 1024
            and p["smem"] <= _cu_constant("kCMaxSmem"))


def _unpack(zk, zmk, w):
    """deposits_common.cuh unpack_pair in complex128: (X[j], X[m − j])."""
    ze = 0.5 * (zk + np.conj(zmk))
    zo = -0.5j * (zk - np.conj(zmk))
    t = w * zo
    return ze + t, np.conj(ze - t)


def _cluster_mirror(s: np.ndarray, lc: int):
    """One frame s (N,) through the cluster kernel's schedule → (bins
    0 … N/2, the write counts of each phase's tile addresses)."""
    n = s.size
    n1, n2 = factors(n)
    m = n1 * n2
    p = cluster_plan(n, lc)
    C, W, A, Wp, Q, T = (p["ctas"], p["w"], p["a"], p["wp"], p["q"],
                         p["threads"])
    l1, l2 = n1.bit_length() - 1, n2.bit_length() - 1
    lw, la = W.bit_length() - 1, A.bit_length() - 1
    tw4 = np.exp(-2j * np.pi * np.outer(np.arange(n1), np.arange(n2)) / m)
    tw = np.exp(-2j * np.pi * np.arange(m) / n)
    size = n1 * Wp
    assert size == n2 * Q                      # A·W' = W·Q
    tiles = [np.full(size, np.nan + 0j) for _ in range(C)]
    counts = {ph: [np.zeros(size, int) for _ in range(C)]
              for ph in ("load", "exchange")}
    # 1. load: group g = t + q·T, q < kCP/2
    g = np.arange(8 * T)
    row, c = g >> (lw - 1), (g & ((1 << (lw - 1)) - 1)) << 1
    for r in range(C):
        off = ((row << l2) + (r << lw) + c) << 1
        dst = row * Wp + c
        tiles[r][dst] = s[off] + 1j * s[off + 1]
        tiles[r][dst + 1] = s[off + 2] + 1j * s[off + 3]
        np.add.at(counts["load"][r], dst, 1)
        np.add.at(counts["load"][r], dst + 1, 1)
    # 2. column L < W: elements L + e·W', e < n1; TW on the last pass
    e = np.arange(n1)
    for r in range(C):
        for L in range(W):
            col = tiles[r][L + e * Wp]
            tiles[r][L + e * Wp] = np.fft.fft(col) * tw4[:, (r << lw) + L]
    # 3. the exchange: a group's reads on every rank, then its stores
    e = np.arange(HELD * T)
    assert HELD * T == (C // 2) * A * W
    aa, jj = (e >> lw) & (A - 1), e & (W - 1)
    for grp in range(2):
        held = []
        for r in range(C):
            peer = r ^ ((grp << (lc - 1)) + (e >> (la + lw)))
            v = np.array([tiles[pp][((r << la) + a) * Wp + j]
                          for pp, a, j in zip(peer, aa, jj)])
            held.append((peer, v))
        for r, (peer, v) in enumerate(held):
            at = ((peer << lw) + jj) * Q + aa
            tiles[r][at] = v
            np.add.at(counts["exchange"][r], at, 1)
    # 4. row aa < A: elements aa + k·Q, k < n2
    k = np.arange(n2)
    for r in range(C):
        for a in range(A):
            tiles[r][a + k * Q] = np.fft.fft(tiles[r][a + k * Q])
    # 5. the unpack: pair qq → j = r·A + ℓ + n1·k2 < m/2, its mirror from
    # the rank that owns row (m − j) mod n1
    out = np.full(m + 1, np.nan + 0j)
    bins = np.zeros(m + 1, int)
    qq = np.arange(PAIRS * T)
    assert PAIRS * T == A * n2 // 2
    ell, k2 = qq & (A - 1), qq >> la
    for r in range(C):
        j = (r << la) + ell + (k2 << l1)
        jm = np.where(j == 0, 0, m - j)
        rowm = jm & (n1 - 1)
        owner = rowm >> la
        zm = np.array([tiles[o][(x >> l1) * Q + (y & (A - 1))]
                       for o, x, y in zip(owner, jm, rowm)])
        lo, hi = _unpack(tiles[r][k2 * Q + ell], zm, tw[j])
        out[j], out[m - j] = lo, hi
        np.add.at(bins, j, 1)
        np.add.at(bins, m - j, 1)
    z = tiles[0][(n2 // 2) * Q]
    out[m // 2] = _unpack(z, z, tw[m // 2])[0]
    bins[m // 2] += 1
    return out, counts, bins


@pytest.mark.parametrize("n,lc", [(n, lc) for n in SIZES
                                  for lc in range(1, 5) if _fits(n, lc)])
def test_the_cluster_mirror_is_the_real_dft(n, lc):
    """The cluster kernel's schedule in complex128 gives ``np.fft.rfft``
    within 1e-12 of the peak, at the plan's cluster size and every other
    that fits; each used tile address is written once by the load and
    once by the exchange, each bin once."""
    s = np.random.default_rng(n + lc).standard_normal(n)
    got, counts, bins = _cluster_mirror(s, lc)
    want = np.fft.rfft(s)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    p = cluster_plan(n, lc)
    for r in range(p["ctas"]):
        loaded = counts["load"][r]
        assert set(np.unique(loaded)) == {0, 1}
        assert loaded.sum() == factors(n)[0] * p["w"]
        exch = counts["exchange"][r]
        assert set(np.unique(exch)) == {0, 1}
        assert exch.sum() == factors(n)[1] * p["a"]
    assert (bins == 1).all()


def test_every_plan_size_has_a_plan_that_fits():
    """The plan by N alone: C ≤ 16 CTAs, 128–1024 threads and at most
    232,448 shared bytes a CTA, ≥ 16 rows and columns a CTA; the
    Python plan's constants are the ``.cu``'s."""
    assert rfft.CLUSTER_POINTS == _cu_constant("kCP")
    assert rfft.MAX_SMEM == _cu_constant("kCMaxSmem") == 232448
    assert HELD == PAIRS == rfft.CLUSTER_POINTS // 2
    for n in SIZES:
        p = cluster_plan(n)
        assert _fits(n, p["log2c"]), (n, p)
        assert p["ctas"] <= 16 and p["threads"] <= 1024
        assert p["smem"] <= 232448
        n1, n2 = factors(n)
        assert p["a"] * p["wp"] == p["w"] * p["q"]
        assert p["threads"] * rfft.CLUSTER_POINTS * p["ctas"] == n1 * n2
        assert cluster_plan(n) == cluster_plan(n, CLUSTER_LOG2C[n])


@pytest.mark.parametrize("n", [1 << k for k in range(8, 16)])
def test_the_block_route_covers_each_address_and_bin_once(n):
    """The block kernel's numbering (``rfft.cu``): groups g = t + q·T of
    4 samples at frame g >> lg land on each tile address of each frame
    once; bins g = t + q·T at frame g >> lb plus the last bin of each
    frame store each output once — with a ragged last block and a single
    frame (frames past the batch left unread and unstored), each thread
    walking only the slots q < ⌈frames·2^lg / T⌉ (⌈frames·2^lb / T⌉ for
    the bins) that can hold a frame of the block."""
    n1, n2 = factors(n)
    packed = n != 256
    m = n1 * n2
    log2m = m.bit_length() - 1
    P = 32 if log2m >= 14 else 16
    log2f = max(0, 11 - log2m)
    F = 1 << log2f
    T = F * m // P
    fs = n1 * (n2 + 1)
    lg = log2m - 1 if packed else log2m - 2
    lb = log2m if packed else log2m - 1
    for frames in sorted({F, max(1, F - 3), 1}):
        live = min(P // 2 if packed else P // 4, -(-(frames << lg) // T))
        g = (np.arange(T)[:, None] + np.arange(live) * T).ravel()
        j, e = g >> lg, g & ((1 << lg) - 1)
        keep = j < frames
        i = (e << 1) if packed else (e << 2)
        dst = j * fs + (i >> (n2.bit_length() - 1)) * (n2 + 1) + (i & (n2 - 1))
        hits = np.zeros(F * fs, int)
        for d in range(2 if packed else 4):
            np.add.at(hits, dst[keep] + d, 1)
        used = np.zeros(F * fs, bool)
        for f in range(frames):
            rows = f * fs + np.arange(n1)[:, None] * (n2 + 1)
            used[(rows + np.arange(n2)).ravel()] = True
        assert (hits[used] == 1).all() and (hits[~used] == 0).all()
        per = min(P if packed else P // 2, -(-(frames << lb) // T))
        gb = (np.arange(T)[:, None] + np.arange(per) * T).ravel()
        jb, kb = gb >> lb, gb & ((1 << lb) - 1)
        bins = np.zeros((F, (1 << lb) + 1), int)
        np.add.at(bins, (jb[jb < frames], kb[jb < frames]), 1)
        bins[:frames, 1 << lb] += 1
        assert (bins[:frames] == 1).all() and (bins[frames:] == 0).all()


def test_routes_by_size_alone_and_forced_only_by_keyword():
    """``route_of`` by N alone: "cluster" from ``CLUSTER_MIN_N``, never
    "large"; every size's own route first in ``routes_of``; the parent
    routes reached only through the keyword ``route=``."""
    for k in range(8, 19):
        n = 1 << k
        assert routes_of(n)[0] == route_of(n) != "large"
        assert route_of(n) == ("full" if n == 256 else "block"
                               if n < rfft.CLUSTER_MIN_N else "cluster")
    assert set(routes_of(65536)) == {"cluster", "large"}
    assert set(routes_of(32768)) == {"block", "cluster"}
    sig = inspect.signature(rfft_frames)
    assert sig.parameters["route"].kind is inspect.Parameter.KEYWORD_ONLY
    assert sig.parameters["route"].default is None


@pytest.mark.parametrize("route,n,match", [
    ("large", 32768, "does not hold"),
    ("cluster", 8192, "does not hold"),
    ("block", 65536, "does not hold"),
    ("nope", 4096, "does not hold"),
    ("cluster", 1000, "powers of two"),
    ("cluster", 65536, "expected a CPU or CUDA"),
])
def test_the_refusals_read_the_same_before_the_device_check(route, n, match):
    """A route that does not hold N, then a size, is refused before the
    device is looked at: the same ValueError on the CPU as on a card."""
    with pytest.raises(ValueError, match=match):
        rfft._launch(torch.zeros(2, n), None, False, route=route)


def test_a_forced_route_on_the_cpu_is_the_plain_version():
    """On the CPU every route is the plain version (``torch.fft``); a
    route that does not hold N is refused there too."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (3, 16384)).astype(np.float32))
    want = rfft.rfft_frames_plain(x)
    for r in routes_of(16384):
        assert torch.equal(rfft_frames(x, route=r), want)
    with pytest.raises(ValueError, match="does not hold"):
        rfft_frames(x, route="large")


def test_the_module_imports_without_nvcc_and_asks_no_card():
    """Importing the wrapper needs no ``nvcc`` and no card; the plan and
    the routes are plain Python; ``require_card`` on a machine without a
    card asks nothing (a launch there raises on its own)."""
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_HOME="/nonexistent",
               PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c",
         "import emspec_torch.dsp.kernels.rfft as r; "
         "r.require_card((65536, 262144), 'cuda', 'x'); "
         "print(r.route_of(65536), r.cluster_plan(262144)['ctas'], "
         "r.rfft_frames.route_launches['cluster'])"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["cluster", "16", "0"]
