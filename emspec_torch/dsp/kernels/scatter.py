"""Kernel B2 wrapper — per-row histogram (the reassignment scatter-add)
(counterpart of ``emspec/dsp/pallas/scatter.py::histogram_matmul``;
source ``emspec_torch/csrc/histogram.cu``).

Two routes on the card, chosen by the shape ``(rows, m, num_bins)``
alone (``route_of``), never by the data:

* "row": one block a row, the row's histogram in shared memory, stored
  whole (no zeroed output) — where the rows alone give every SM two
  blocks (``ROW_MIN_ROWS``) and four such blocks fit an SM's shared
  memory (``ROW_MAX_BINS``);
* "global": every other shape, every ``num_bins`` above a block's shared
  memory (``SMEM_BINS``) included: the flat rows·m stream of deposits,
  spread over ``global_blocks`` blocks whatever the row count, goes
  straight into a zeroed output with global atomics.

Both merge equal ids within a warp before the atomic (the ids of real
audio cluster on a few hot cells) and read ids and vals with 16-byte
loads where the two share their alignment.  ``histogram(..., route=...)``
forces a route, for tests and timing only; the pipeline never passes it.
The thresholds are card timings (PERF.md §6).

Float atomics add a cell's deposits in an order that changes from run to
run, so two runs can differ in the last bit of a cell.  The pipeline's
default asks for the third route, ``"sorted"`` (``SORTED``): every cell
adds its deposits in deposit order, with no atomics — deterministic, and
bit-equal to the plain version; the atomic routes are taken where a
caller passes ``exact_sums=False``.  The sorted route has three forms,
each with its own count in ``histogram.route_launches``:

* ``"sorted_tiles"`` (``SORTED_TILES``), where the caller says how far a
  deposit lands from its frame (``reach=R, frame_len=K``, and
  ``column_len=C``, K by default: a row holds frames of K deposits, ids
  are cells column·C + f of as many columns, and frame s lands in columns
  s − R … s + R).  One launch, no sort: a block owns a tile of
  ``tile_plan``'s columns × cells in shared memory and walks the deposits
  of the frames that reach it in order, each of its warps adding the
  deposits of its own cells one after another in (frame, bin) order.
  The single-bank raster takes it (``dsp.reassign.scatter_segment_sum``,
  R = ceil(N / 2·hop), C = K), and so do the pipeline's enhanced batch
  calls whose frames hold no more deposits than a column has rows
  (``Pipeline.process``: the absolute (t, rows) grid, C = rows, K the
  banks' deposits a frame, R the pipeline's reach: the display default),
  so an export and a render of the same file agree pixel for pixel;
* ``"sorted_batch"`` (``SORTED_BATCH``), with the same bound: one
  launch, no sort, a CTA a tile of columns and a band of rows
  (``batch_plan``) reading the deposits of the frames that reach it and
  keeping its own, packed in deposit order into shared memory, its warps
  — each owning interleaved blocks of rows, so the crowded top rows of a
  log raster spread over all of them — walking its cells' deposits in
  (frame, bin) order.  Every enhanced batch call of the pipeline takes it
  or the tiles form, by shape (``sorted_form``);
* ``"sorted"``, without that bound: a stable ``torch.sort`` of the keys
  (row, id), then one thread sums each cell's run of deposits.  On no
  default path: it serves callers that give no bound, and the A/B;
* ``"sorted_ring"`` (``SORTED_RING``, ``histogram_ring``): one hop of the
  live step added into its pending ring (P, ..., C) in place, each cell
  adding the hop's deposits in bin order onto the value it holds — so a
  stream sums every column in the batch's (frame, bin) order, and the
  card's default ``Stream`` gives ``process``'s columns bit for bit.  It
  takes B1's relative ids and the step's frame counter ``t`` in device
  memory and computes each deposit's ring cell itself.  One launch a hop,
  a cluster of CTAs a lane at a grid fixed by the shape (``ring_plan``),
  so the hop's CUDA graph captures it; where a hop's entries or a lane's
  ring outgrow one CTA's shared memory (above 32768 points, a short hop,
  a tall raster), the hop in windows walked in bin order and the ring in
  bands of slots, a cluster each.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from emspec_torch import kernels_build
from emspec_torch.dsp.kernels import (
    counted, launch_stream, require, require_cuda)

# float32 cells one block's shared memory holds (227 KB on the H100):
# the bound of B2's row route and of B6's large route
SMEM_BINS = 232448 // 4
ROUTES = ("row", "global")    # the atomic routes, chosen by route_of
SORTED = "sorted"             # the deterministic route, on request
SORTED_TILES = "sorted_tiles"     # ... its form with a window bound
SORTED_RING = "sorted_ring"       # ... its form for one hop into a ring
SORTED_BATCH = "sorted_batch"     # ... its form for crowded columns
FORMS = ("tiles", "batch")        # the bounded forms, chosen by sorted_form
ROW_THREADS = 512         # histogram.cu kRowThreads
GLOBAL_THREADS = 256      # histogram.cu kGlobalThreads
SMS = 132                 # the H100's streaming multiprocessors
ROW_MIN_ROWS = 2 * SMS    # row: two blocks an SM from the rows alone
ROW_MAX_BINS = SMEM_BINS // 4     # row: four blocks of 512 an SM
GLOBAL_BLOCKS = 8 * SMS   # global: blocks at most (8 of 256 an SM)
TILE_WARPS = 16           # histogram.cu kTileWarps: the sorted tiles' warps
TILE_COLS = 3             # columns a tile by default (the raster's best)
TILE_CELLS = 24320        # cells a tile at most (95 KB, and 95 KB of claims)
PIECE_CHUNKS = 144        # histogram.cu kPieceChunks: 32-bin chunks a piece
BATCH_ROUND = 8 * 32 * TILE_WARPS  # histogram_batch.cu kRound: a round
BATCH_BANDS = 16        # histogram_batch.cu kMaxBands
BATCH_MAX_SHIFT = 4     # histogram_batch.cu kMaxShift: 16 rows a block
BATCH_CELLS = 24576     # a CTA's cells at most (its tile leaves room for a
                        # piece of ≥ 16,000 entries; 16-bit entries)
BATCH_PACKED_READS = 4  # reads a kept deposit, above which entries pack
RING_MAX_CLUSTER = 16     # histogram_ring.cu kMaxCluster (16: non-portable)
RING_PORTABLE = 8         # the largest portable cluster size
RING_STAGE = 16 * 16      # chunks a rank stages (kMaxStage · kWarps)
RING_CELLS = 0xffff       # a rank's cells at most (16-bit keys, one spare)
RING_LOCAL_CHUNKS = 16    # a hop this many chunks of 32 at most: no cluster
RING_WINDOW = 256         # chunks a window at least where bands are needed
SMEM_BYTES = 232448       # a block's shared memory (histogram.cu kMaxSmem)


def route_of(rows: int, m: int, num_bins: int) -> str:
    """B2's route for ``rows`` rows of ``m`` deposits into ``num_bins``
    cells: by shape only."""
    del m                     # the measured crossovers did not move with m
    if rows >= ROW_MIN_ROWS and num_bins <= ROW_MAX_BINS:
        return "row"
    return "global"


def global_blocks(rows: int, m: int) -> int:
    """The global route's grid: a 16-byte vector of deposits a thread,
    at most ``GLOBAL_BLOCKS`` blocks (a grid-stride loop beyond)."""
    vectors = -(-(rows * m) // 4)
    return max(1, min(-(-vectors // GLOBAL_THREADS), GLOBAL_BLOCKS))


def tile_plan(frames: int, k: int, reach: int,
              tile_cols: int | None = None,
              column: int | None = None) -> dict:
    """The sorted tiles' grid for ``frames`` frames of ``k`` deposits into
    as many columns of ``column`` cells (``k`` by default) at reach R:
    ``cols`` × ``cells`` a tile (at most ``TILE_CELLS`` cells; a column of
    more than that is cut into row tiles), cell f − f0 of a column owned
    by warp ((f − f0)·``owner_mul``) >> 16, the frames a tile walks
    (``cols`` + 2R, fewer at the ends) in at most ``pieces`` pieces: of
    ``frames_per_piece`` whole frames where they fit ``PIECE_CHUNKS``
    chunks of 32, else each frame (``chunks`` chunks) in pieces of
    ``piece_chunks`` chunks; and the shared memory: the tile and its
    claim words, then one piece's keys, values and chunk masks.  A tile is
    ``TILE_COLS`` columns wide, or wider where that leaves more tiles than
    the card has SMs (a tile of c columns re-reads (c + 2R)/c frames: at
    the display default's R = 32 and 5,937 columns, 45 columns a tile
    where 3 would walk 67 frames for 3 columns).  ``tile_cols`` stands in
    for that width (the CPU mirror walks other widths)."""
    c_len = column or k
    width = tile_cols or max(TILE_COLS, -(-frames // SMS))
    cols = min(width, max(TILE_CELLS // c_len, 1), frames)
    cells = min(c_len, TILE_CELLS // cols)
    walk = min(cols + 2 * reach, frames)
    fp = min(PIECE_CHUNKS * 32 // k, walk)
    chunks = -(-k // 32)                      # a frame's
    if fp > 0:
        pc, pieces = -(-fp * k // 32), -(-walk // fp)
    else:
        pc = -(-chunks // -(-chunks // PIECE_CHUNKS))
        pieces = walk * -(-chunks // pc)
    return dict(cols=cols, cells=cells, col_tiles=-(-frames // cols),
                row_tiles=-(-c_len // cells), owner_mul=(1 << 20) // cells,
                walk=walk, chunks=chunks, frames_per_piece=fp,
                piece_chunks=pc, pieces=pieces,
                smem=8 * cols * cells + pc * (32 * 8 + 4))


def batch_plan(frames: int, k: int, reach: int, column: int | None = None,
               lanes: int = 1, bands: int | None = None,
               tile_cols: int | None = None,
               row_shift: int | None = None,
               packed: bool | None = None) -> dict:
    """The batch form's grid for ``lanes`` lanes of ``frames`` frames of
    ``k`` deposits into as many columns of ``column`` cells (``k`` by
    default) at reach R: one CTA a lane's tile of ``cols`` columns in one of
    ``bands`` row bands (``col_tiles`` tiles a lane), the rows in blocks of
    2^``row_shift`` (4 rows where a frame holds fewer than 64 deposits a
    row, else single rows: the 262144 cell's top rows hold hundreds), block
    B = f >> row_shift in band B mod ``bands`` and owned by warp
    (B div ``bands``) mod 16; ``rb`` local rows a column, ``cells`` =
    cols·rb a CTA; the frames a tile reads (cols + 2R, fewer at the ends);
    an entry array of ``cap`` entries (8 bytes each, a mask a 32) for one
    piece of the CTA's own deposits, the rest of the shared memory after
    the cells, ``packed`` (the kept deposits packed in deposit order, where
    a CTA reads more than ``BATCH_PACKED_READS`` deposits for each it
    keeps: most raw chunks hold few of its own) or each raw chunk's own
    one chunk of entries, each cell one run.  ``fits``: within the kernel's
    limits (``SMEM_BYTES`` among them).  By default the bands are the
    largest power of two (≤ 16) that keeps lanes × frames × bands within
    the card's SMs (``SMS``: more than one only where the frames are few),
    and the tiles as many as the SMs hold, one CTA each.  ``bands``,
    ``tile_cols``, ``row_shift`` and ``packed`` stand in for the choice,
    for tests and timing."""
    c_len = column or k
    shift = (2 if k < 64 * c_len else 0) if row_shift is None else row_shift
    if bands is None:
        bands = 1
        while bands < BATCH_BANDS and lanes * frames * bands * 2 <= SMS:
            bands *= 2
    log_b = bands.bit_length() - 1
    rb = (((c_len - 1) >> (shift + log_b)) + 1) << shift
    cols = tile_cols or -(-frames // max(1, min(frames,
                                                SMS // (lanes * bands))))
    cols = max(1, min(cols, frames, BATCH_CELLS // rb))
    cells = cols * rb
    tile = 4 * ((cells + cells // 32 + 16) & ~15)
    cap = (SMEM_BYTES - 4 * 2 * TILE_WARPS - tile) * 32 // (8 * 32 + 4) \
        // 32 * 32
    smem = 8 * cap + 4 * (cap // 32) + 4 * 2 * TILE_WARPS + tile
    tiles = -(-frames // cols)
    walk = min(cols + 2 * reach, frames)
    packed = walk * bands > BATCH_PACKED_READS * cols if packed is None \
        else packed
    return dict(bands=bands, cols=cols, col_tiles=tiles, row_shift=shift,
                rb=rb, cells=cells, walk=walk, packed=packed,
                cap=cap, smem=smem, ctas=lanes * tiles * bands,
                fits=bands & (bands - 1) == 0 and bands <= BATCH_BANDS
                and 0 <= shift <= BATCH_MAX_SHIFT and cells <= 0xffff
                and cap >= BATCH_ROUND and smem <= SMEM_BYTES
                and frames * c_len < 2**31)


def sorted_form(frames: int, k: int, reach: int,
                column: int | None = None, lanes: int = 1) -> str:
    """The sorted route's bounded form for ``lanes`` lanes of ``frames``
    frames of ``k`` deposits into as many columns of ``column`` cells
    (``k`` by default) at reach R, by shape: ``"tiles"`` where a frame holds
    no more deposits than a column holds cells (k ≤ column: the display
    default's 382 deposits into 512 rows, the raster's K into K: a tile's
    warps meet about one deposit a cell a frame and no tile re-reads much),
    else ``"batch"`` (crowded columns: 4097 to 131,073 deposits a frame into
    512 rows), where ``batch_plan`` fits.  On the H100 the batch form ran
    every crowded batch cell fastest of the three sorted forms (2–4.3×
    below the global sort at 8192 and 32768, 1.46× at 262144, 1.12× at
    hop 64), and the tiles form the display default (PERF.md §6)."""
    c_len = column or k
    if k <= c_len:
        return "tiles"
    return "batch" if batch_plan(frames, k, reach, c_len, lanes)["fits"] \
        else "tiles"


def _padded16(cells: int) -> int:
    """``histogram_ring.cu``'s tile: a word of padding every 32 cells, to a
    multiple of 16 with one spare."""
    return (cells + cells // 32 + 16) & ~15


def ring_plan(k: int, slots: int, column: int, cluster: int | None = None,
              lanes: int = 1, clusters16: int = 0,
              local: bool | None = None, window: int | None = None,
              bands: int | None = None) -> dict:
    """The ring form's grid for a hop of ``k`` deposits a lane into a ring
    of ``slots`` (odd: 2R + 1) × ``column`` cells a lane, ``lanes`` lanes:
    S = ``cluster`` CTAs a lane's band (a power of two), rank o owning the
    rows in 8-row groups g with g mod S = o, ``rb`` local rows a slot (a
    multiple of 16), ``cells`` = ``band_slots`` × rb a rank.  The S CTAs
    form a cluster in which each stages ``window_chunks`` of each window's
    chunks of 32 deposits (``stage_chunks`` of the hop's ``chunks`` in
    all) and sends each to its owner, or — ``local``, a hop of at most
    ``RING_LOCAL_CHUNKS`` chunks — each stages the whole window and keeps
    its own rows' deposits (no cluster barrier).  The hop is staged in
    ``windows`` windows of ``window`` chunks, and a lane's ring cut into
    ``bands`` bands of ``band_slots`` slots, a cluster (or S local CTAs)
    each.  The shared memory: an 8-byte entry a deposit of a window, the
    rank's cells and their touched flags, a mask a chunk of the window.
    ``fits``: within the kernel's limits.

    Where some S takes the whole hop in one window and the whole ring in
    one band, the plan is that (one window, one band): by default the
    smallest S that fits, doubled while the lanes' CTAs take at most half
    the card's SMs (``SMS``) and S stays portable (8), or 16 where the card
    holds a cluster of 16 a lane at once (``clusters16``,
    ``ring_occupancy``: 16 is non-portable).  On the H100 the largest S
    that fits so ran each mono hop fastest, 4 the 16-lane one, and the
    local form the display default's hop of 382 deposits (PERF.md §6).
    Where none does (a hop above 28,480 deposits at 5 × 512 cells, 32,769
    to 131,073 above 32768 points; a ring of more cells than S = 16 CTAs
    hold, at a short hop or a tall raster), S doubles from 1 by the same
    rule, the fewest bands leave room for a window of
    min(chunks, ``RING_WINDOW``) chunks, and the windows are as few as the
    rest of the shared memory allows, of equal length.  ``cluster``,
    ``local``, ``window`` and ``bands`` stand in for the choice, for tests
    and timing."""
    chunks = -(-k // 32)
    local = chunks <= RING_LOCAL_CHUNKS if local is None else local

    def plan(s: int, w: int = chunks, band: int = slots) -> dict:
        rb = -(-column // (TILE_WARPS * s)) * TILE_WARPS
        cells = band * rb
        cs = chunks if local else -(-chunks // s)
        cw = w if local else -(-w // s)
        smem = 256 * w + 5 * _padded16(cells) + 4 * w
        return dict(cluster=s, local=local, rb=rb, cells=cells,
                    chunks=chunks, stage_chunks=cs, smem=smem,
                    window=w, windows=-(-chunks // w), window_chunks=cw,
                    band_slots=band, bands=-(-slots // band),
                    fits=0 < s <= RING_MAX_CLUSTER and s & (s - 1) == 0
                    and slots % 2 == 1 and cells <= RING_CELLS
                    and cw <= RING_STAGE and smem <= SMEM_BYTES
                    and 0 < w <= chunks and 0 < band <= slots)

    def split(s: int) -> dict:
        rb = -(-column // (TILE_WARPS * s)) * TILE_WARPS
        if bands is not None:
            band = -(-slots // bands)
        else:               # the most slots that leave room for the window
            room = SMEM_BYTES - (32 * 8 + 4) * (
                window or min(chunks, RING_WINDOW))
            cells = min(RING_CELLS, max(room // 5 - 32, 0) * 32 // 33)
            while 5 * _padded16(cells + 1) <= room and cells < RING_CELLS:
                cells += 1
            band = min(slots, cells // rb)
            if band == 0:
                return plan(s, window or chunks, 1) | dict(fits=False)
            band = -(-slots // -(-slots // band))     # bands of equal length
        w = window
        if w is None:       # the fewest windows the rest holds, equal ones
            w = min(chunks, RING_STAGE * (1 if local else s),
                    max(SMEM_BYTES - 5 * _padded16(band * rb), 0)
                    // (32 * 8 + 4))
            w = -(-chunks // -(-chunks // w)) if w > 0 else chunks
        return plan(s, w, band)

    # a plan's fit only grows with S: one window and one band at some S
    # is one at the largest
    whole = window is None and bands is None \
        and plan(RING_MAX_CLUSTER)["fits"]
    pick = plan if whole else split
    if cluster is not None:
        return pick(cluster)
    s = 1
    while s < RING_MAX_CLUSTER and not pick(s)["fits"]:
        s *= 2
    while (2 * s <= RING_MAX_CLUSTER and lanes * 2 * s <= SMS // 2
           and (2 * s <= RING_PORTABLE or local or clusters16 >= lanes)):
        s *= 2
    return pick(s)


def histogram_plain(ids: torch.Tensor, vals: torch.Tensor, num_bins: int,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """``histogram_reference``: per leading row, Σ vals into cells by id
    (into ``out`` in place where given), each cell adding in deposit
    order.  A dropped id adds value 0 to a spare cell, so a NaN/Inf behind
    it never lands."""
    lead = ids.shape[:-1]
    b = math.prod(lead)
    ok = (ids >= 0) & (ids < num_bins)
    v = torch.where(ok, vals, torch.zeros_like(vals)).reshape(-1)
    if out is not None:                  # the spare cell: 0 into cell 0
        safe = torch.where(ok, ids, 0).to(torch.int64).reshape(b, -1)
        safe = safe + (torch.arange(b, device=ids.device)
                       * num_bins)[:, None]
        out.view(-1).index_add_(0, safe.reshape(-1), v)
        return out
    safe = torch.where(ok, ids, num_bins).to(torch.int64).reshape(b, -1)
    safe = safe + (torch.arange(b, device=ids.device)
                   * (num_bins + 1))[:, None]
    hist = torch.zeros(b * (num_bins + 1), dtype=torch.float32,
                       device=ids.device)
    hist.index_add_(0, safe.reshape(-1), v)
    return hist.view(b, num_bins + 1)[:, :num_bins].reshape(
        lead + (num_bins,))


@counted
def histogram(ids: torch.Tensor, vals: torch.Tensor, num_bins: int,
              passes: int = 2, *, route: str | None = None,
              out: torch.Tensor | None = None, reach: int | None = None,
              frame_len: int | None = None,
              column_len: int | None = None,
              form: str | None = None) -> torch.Tensor:
    """ids (..., M) int32, vals (..., M) float32 → (..., num_bins) float32.

    An id outside [0, num_bins) contributes nothing, even when its value
    is NaN or Inf.  ``passes`` is accepted for the JAX signature and is
    moot here: the kernel adds in float32, each add exact to one rounding
    (the TPU kernel split values into bf16 terms).  ``route`` ("row" or
    "global") overrides ``route_of``, for tests and timing; ``"sorted"``
    asks for the deterministic route.  ``out``, a
    contiguous float32 (..., num_bins) tensor, is added into in place and
    returned (the global route: its atomics add into whatever the output
    holds) — the live step's ring; the sorted route adds into it too.
    ``reach``, ``frame_len`` and ``column_len`` (the sorted route only)
    bound where a deposit lands, for its tiles form (module docstring):
    ``num_bins`` = T·``column_len`` cells (``column_len`` defaults to
    ``frame_len``), the ids' last axis T·``frame_len`` deposits, and frame
    s's ids lie in columns s − reach … s + reach (a deposit outside them
    is not added).  With the bound, ``form`` ("tiles" or "batch") forces
    that form, for tests and timing; by default ``sorted_form`` picks it
    by shape."""
    del passes
    require(form is None or (form in FORMS and reach is not None),
            "histogram", f"form {form!r}: one of {FORMS}, with reach")
    if reach is not None or frame_len is not None or column_len is not None:
        c_len = column_len or frame_len
        require(route == SORTED and reach is not None and reach >= 0
                and frame_len is not None and 0 < frame_len
                and c_len > 0 and num_bins % c_len == 0
                and ids.shape[-1:] == (num_bins // c_len * frame_len,),
                "histogram",
                f"reach and frame_len bound the sorted route's deposits: "
                f"ids (..., T·frame_len) in frames of frame_len deposits "
                f"into {num_bins} cells, T columns of column_len (reach "
                f"{reach}, frame_len {frame_len}, column_len {column_len})")
    if ids.device.type == "cpu":
        return histogram_plain(ids, vals, num_bins, out)
    what = "histogram"
    require_cuda(ids, what)
    require(ids.dtype == torch.int32 and vals.dtype == torch.float32, what,
            "ids must be int32 and vals float32")
    require(ids.shape == vals.shape and vals.device == ids.device, what,
            "ids and vals must share shape and device")
    require(ids.is_contiguous() and vals.is_contiguous(), what,
            "ids and vals must be contiguous")
    require(0 < num_bins < 2**31, what,
            f"num_bins={num_bins} outside (0, 2**31)")
    require(route is None or route in ROUTES + (SORTED,), what,
            f"route {route!r} not in {ROUTES + (SORTED,)}")
    lead = ids.shape[:-1]
    rows = math.prod(lead)
    m = ids.shape[-1] if ids.dim() else 1
    if route == SORTED and reach is not None:
        c_len = column_len or frame_len
        form = form or sorted_form(num_bins // c_len, frame_len, reach,
                                   c_len, rows)
        sum_ = _sorted_batch if form == "batch" else _sorted_tiles
        return sum_(ids, vals, num_bins, out, lead, rows, reach=reach,
                    k=frame_len, c_len=c_len)
    if route == SORTED:
        return _sorted(ids, vals, num_bins, out, lead, rows)
    route = route or ("global" if out is not None
                      else route_of(rows, m, num_bins))
    require(route == "global" or num_bins <= SMEM_BINS, what,
            f"the row route holds at most {SMEM_BINS} cells in shared "
            f"memory, not {num_bins}")
    if out is None:
        alloc = torch.empty if route == "row" else torch.zeros
        out = alloc(lead + (num_bins,), dtype=torch.float32,
                    device=ids.device)
    else:
        require(route == "global" and out.dtype == torch.float32
                and out.shape == lead + (num_bins,) and out.is_contiguous()
                and out.device == ids.device, what,
                f"out must be a contiguous float32 {lead + (num_bins,)} "
                f"tensor on the ids' device, added into by the global route")
    a0 = ids.data_ptr() % 16
    with torch.cuda.device(ids.device):
        rc = kernels_build.library().emspec_histogram(
            ids.data_ptr(), vals.data_ptr(), out.data_ptr(), rows, m,
            num_bins, ROUTES.index(route), global_blocks(rows, m), a0 // 4,
            int(vals.data_ptr() % 16 == a0), launch_stream(ids))
    kernels_build.check(rc, what)
    histogram.launches += 1
    histogram.route_launches[route] += 1
    return out


histogram.route_launches = dict.fromkeys(
    ROUTES + (SORTED, SORTED_TILES, SORTED_BATCH, SORTED_RING), 0)


def _sorted_out(ids, num_bins: int, out, lead: tuple, alloc):
    if out is None:
        return alloc(lead + (num_bins,), dtype=torch.float32,
                     device=ids.device)
    require(out.dtype == torch.float32 and out.is_contiguous()
            and out.shape == lead + (num_bins,)
            and out.device == ids.device, "histogram",
            f"out must be a contiguous float32 {lead + (num_bins,)} "
            f"tensor on the ids' device")
    return out


def _sorted_tiles(ids, vals, num_bins: int, out, lead: tuple, rows: int, *,
                  reach: int, k: int, c_len: int):
    """The sorted route's tiles form (module docstring): one launch, each
    cell written once."""
    frames = num_bins // c_len
    plan = tile_plan(frames, k, reach, column=c_len)
    add = out is not None
    out = _sorted_out(ids, num_bins, out, lead, torch.empty)
    with torch.cuda.device(ids.device):
        rc = kernels_build.library().emspec_histogram_tiles(
            ids.data_ptr(), vals.data_ptr(), out.data_ptr(), rows, frames, k,
            c_len, reach, plan["cols"], plan["cells"], plan["piece_chunks"],
            plan["frames_per_piece"], int(add), launch_stream(ids))
    kernels_build.check(rc, "histogram")
    histogram.launches += 1
    histogram.route_launches[SORTED_TILES] += 1
    return out


def _sorted_batch(ids, vals, num_bins: int, out, lead: tuple, rows: int,
                  *, reach: int, k: int, c_len: int):
    """The sorted route's batch form (module docstring): one launch at
    ``batch_plan``'s grid, each cell written once."""
    frames = num_bins // c_len
    plan = batch_plan(frames, k, reach, c_len, rows)
    require(plan["fits"], "histogram",
            f"{rows} lanes of {frames} frames of {k} deposits into columns "
            f"of {c_len} cells at reach {reach} exceed the batch form "
            f"({plan})")
    add = out is not None
    out = _sorted_out(ids, num_bins, out, lead, torch.empty)
    with torch.cuda.device(ids.device):
        rc = kernels_build.library().emspec_histogram_batch(
            ids.data_ptr(), vals.data_ptr(), out.data_ptr(), rows, frames, k,
            c_len, reach, plan["cols"], plan["bands"].bit_length() - 1,
            plan["row_shift"], plan["cap"], int(plan["packed"]), int(add),
            launch_stream(ids))
    kernels_build.check(rc, "histogram")
    histogram.launches += 1
    histogram.route_launches[SORTED_BATCH] += 1
    return out


def _sorted(ids, vals, num_bins: int, out, lead: tuple, rows: int):
    """B2's sorted route without a window bound (see the module
    docstring): keys row·num_bins + id (−1 where dropped) sorted stably,
    the values gathered into that order, one launch that sums each
    cell's run.  On no default path: the pipeline always gives the bound
    (``histogram(..., route="sorted")`` without ``reach`` asks for it)."""
    what = "histogram"
    out = _sorted_out(ids, num_bins, out, lead, torch.zeros)
    kt = torch.int32 if rows * num_bins < 2**31 else torch.int64
    base = (torch.arange(rows, dtype=kt, device=ids.device)
            * num_bins).reshape(lead + (1,))
    ok = (ids >= 0) & (ids < num_bins)
    keys, order = torch.sort(
        torch.where(ok, ids.to(kt) + base, -1).reshape(-1), stable=True)
    svals = vals.reshape(-1)[order]
    n = keys.numel()
    blocks = max(1, min(-(-n // GLOBAL_THREADS), GLOBAL_BLOCKS))
    with torch.cuda.device(ids.device):
        rc = kernels_build.library().emspec_histogram_sorted(
            keys.data_ptr(), keys.element_size(), svals.data_ptr(),
            out.data_ptr(), n, blocks, launch_stream(ids))
    kernels_build.check(rc, what)
    histogram.launches += 1
    histogram.route_launches[SORTED] += 1
    return out


def ring_ids(ids_rel: torch.Tensor, t, slots: int,
             column: int) -> torch.Tensor:
    """B1's relative ids (δ + R)·C + row of frame ``t`` (a 0-d tensor or an
    int), P = ``slots`` = 2R + 1, C = ``column`` → each lane's ring ids
    slot·C + row, slot = (t + δ) mod P; −1 for an id outside [0, P·C)
    (B1's invalid deposit is −1) and for a column t + δ below 0.  The
    ring form computes the same in its kernel; this is its plain
    version's input."""
    R = slots // 2
    ok = (ids_rel >= 0) & (ids_rel < slots * column)
    delta = torch.div(ids_rel, column, rounding_mode="floor") - R
    slot = torch.remainder(t + delta, slots)
    return torch.where(ok & (t + delta >= 0),
                       slot * column + torch.remainder(ids_rel, column), -1)


def ring_offsets(ids: torch.Tensor, ring: torch.Tensor) -> torch.Tensor:
    """Ring ids slot·C + row of each lane (ids (..., K), ring (P, ..., C))
    → offsets into the flat ring, −1 where an id is outside [0, P·C)."""
    P, C = ring.shape[0], ring.shape[-1]
    lanes = ring[0].numel() // C
    ok = (ids >= 0) & (ids < P * C)
    lane = (torch.arange(lanes, dtype=ids.dtype, device=ids.device)
            * C).reshape(ids.shape[:-1] + (1,))
    flat = (torch.div(ids, C, rounding_mode="floor") * (lanes * C) + lane
            + torch.remainder(ids, C))
    return torch.where(ok, flat, -1)


def histogram_ring_plain(ids: torch.Tensor, vals: torch.Tensor,
                         ring: torch.Tensor) -> torch.Tensor:
    """The ring form's plain version: ``histogram_plain(..., out=)`` of
    the deposits' ring offsets into the flat ring, in place (each cell in
    deposit order; a dropped id adds nothing)."""
    histogram_plain(ring_offsets(ids, ring).reshape(-1), vals.reshape(-1),
                    ring.numel(), out=ring.view(-1))
    return ring


def histogram_ring(ids: torch.Tensor, vals: torch.Tensor,
                   ring: torch.Tensor, t, *, cluster: int | None = None,
                   local: bool | None = None) -> torch.Tensor:
    """B2's sorted route, ring form (module docstring): ids (..., K) int32
    are B1's relative ids (δ + R)·C + row of frame ``t``, vals (..., K)
    float32; ``ring`` (P, ..., C) float32, contiguous, P = 2R + 1, its
    lanes the ids' leading axes, is added into in place and returned:
    the deposit lands in slot (t + δ) mod P.  ``t`` is the step's 0-d
    int32 counter on the ids' device (an int too on the CPU).  Each cell
    adds its deposits in deposit order onto the value it holds — the
    plain version's sum (``histogram_ring_plain`` of ``ring_ids``) bit
    for bit, the same on every run; an id outside [0, P·C) or a column
    t + δ below 0 adds nothing, even when its value is NaN or Inf.
    ``cluster`` and ``local`` force the CTAs a lane's band and the form
    (``ring_plan``), for tests and timing.  Counted as B2's:
    ``histogram.launches``, ``histogram.route_launches["sorted_ring"]``,
    and ``histogram.ring_form_launches`` by ``ring_form``."""
    what = "histogram_ring"
    require(ring.dim() >= 2 and ring.shape[1:-1] == ids.shape[:-1]
            and ids.shape == vals.shape and ids.dim() >= 1
            and ring.shape[0] % 2 == 1, what,
            f"ids and vals (..., K) and a ring (P, ..., C), P odd, with the "
            f"same leading axes; got ids {tuple(ids.shape)}, vals "
            f"{tuple(vals.shape)}, ring {tuple(ring.shape)}")
    P, C, k = ring.shape[0], ring.shape[-1], ids.shape[-1]
    if ids.device.type == "cpu":
        return histogram_ring_plain(ring_ids(ids, t, P, C), vals, ring)
    require_cuda(ids, what)
    require(ids.dtype == torch.int32 and vals.dtype == torch.float32
            and ring.dtype == torch.float32, what,
            "ids must be int32, vals and the ring float32")
    require(isinstance(t, torch.Tensor) and t.dtype == torch.int32
            and t.numel() == 1 and t.device == ids.device, what,
            "t must be a 0-d int32 tensor on the ids' device")
    require(ids.is_contiguous() and vals.is_contiguous()
            and ring.is_contiguous(), what,
            "ids, vals and the ring must be contiguous")
    require(vals.device == ids.device and ring.device == ids.device, what,
            "ids, vals and the ring must share a device")
    return _ring_launch(ids, vals, ring, t, ring_plan_on(
        ids.device, k, P, C, math.prod(ids.shape[:-1]), cluster, local))


def _ring_launch(ids: torch.Tensor, vals: torch.Tensor, ring: torch.Tensor,
                 t: torch.Tensor, plan: dict) -> torch.Tensor:
    """``histogram_ring``'s launch at ``plan``, a ``ring_plan`` of these
    shapes (the card's tests force its window or bands through it)."""
    what = "histogram_ring"
    P, C, k = ring.shape[0], ring.shape[-1], ids.shape[-1]
    lanes = math.prod(ids.shape[:-1])
    require(plan["fits"] and plan["chunks"] == -(-k // 32) and k > 0
            and P * C < 2**31, what,
            f"a ring of {P} × {C} cells a lane and {k} deposits a hop in "
            f"clusters of {plan['cluster']} exceed the kernel "
            f"({plan['cells']} cells a rank, {plan['window_chunks']} chunks "
            f"staged a window, {plan['smem']} bytes)")
    with torch.cuda.device(ids.device):
        rc = kernels_build.library().emspec_histogram_ring(
            ids.data_ptr(), vals.data_ptr(), t.data_ptr(), ring.data_ptr(),
            lanes, k, P, C, plan["cluster"], int(plan["local"]),
            plan["window"], plan["band_slots"], launch_stream(ids))
    kernels_build.check(rc, what)
    histogram.launches += 1
    histogram.route_launches[SORTED_RING] += 1
    histogram.ring_form_launches[ring_form(plan)] += 1
    return ring


def ring_form(plan: dict) -> str:
    """The ring form a ``ring_plan`` names: ``"local"`` or ``"cluster"``
    (one window, one band), else ``"windows"`` (the hop in windows) or
    ``"bands"`` (the ring in bands, the hop in one window or more)."""
    if plan["bands"] > 1:
        return "bands"
    if plan["windows"] > 1:
        return "windows"
    return "local" if plan["local"] else "cluster"


histogram.ring_form_launches = dict.fromkeys(
    ("local", "cluster", "windows", "bands"), 0)


def ring_plan_on(device: torch.device, k: int, slots: int, column: int,
                 lanes: int = 1, cluster: int | None = None,
                 local: bool | None = None) -> dict:
    """The plan ``histogram_ring`` launches on ``device`` (``ring_plan``
    with the card's ``_clusters16`` where no cluster size is forced; none
    on the CPU)."""
    c16 = _clusters16(k, slots, column, lanes, device.index) \
        if cluster is None and device.type == "cuda" else 0
    return ring_plan(k, slots, column, cluster, lanes, c16, local)


@functools.lru_cache(maxsize=64)
def _clusters16(k: int, slots: int, column: int, lanes: int,
                device: int) -> int:
    """``ring_occupancy`` of 16-CTA clusters at this shape (0 where 16
    does not fit), asked once a shape and card."""
    if not ring_plan(k, slots, column, 16, lanes, local=False)["fits"]:
        return 0
    return ring_occupancy(k, slots, column, 16, lanes, device)


def ring_occupancy(k: int, slots: int, column: int, cluster: int,
                   lanes: int = 1, device=None) -> int:
    """How many of the ring form's clusters (its cluster form, not
    ``local``, at ``ring_plan``'s windows and bands for this cluster size)
    at this shape the card holds at once
    (``cudaOccupancyMaxActiveClusters``); 0 where it holds none (a
    non-portable size the card refuses)."""
    plan = ring_plan(k, slots, column, cluster, lanes, local=False)
    if not plan["fits"]:
        return 0
    out = ctypes.c_int(0)
    with torch.cuda.device(device or torch.cuda.current_device()):
        rc = kernels_build.library().emspec_histogram_ring_occupancy(
            lanes, k, slots, column, cluster, plan["window"],
            plan["band_slots"], ctypes.byref(out))
    return out.value if rc == 0 else 0
