"""P1's Hopper redesign (scema_tpu_torch.ops.md_slim, csrc/md_slim_ring.cu)
on the CPU: ``ring_layout``, the wrapper's mirror of the kernel's block,
which sizes each launch (chip_smoke.py phase 18 holds it, field for field,
against the kernel's own), against the variant's slot layout
(``layout_pairs``, which lays out the planes the ring copies): the first
instance up to 512 atoms per box, the big-box instance's column-tiled
stages above, up to each variant's cap (``n_max``).  No GPU and no JAX: the
kernel itself runs only on the card (chip_smoke.py phase 18, whose
bit-for-bit check against the first design covers the copies' offsets);
the plain version against the lab's ``run_slim`` is
tests/test_torch_probe_allpairs.py.
"""
import numpy as np
import pytest
import torch

from scema_tpu_torch.ops import md_slim as MS

SIZES = (128, 256, 512, 640, 1024)
CASES = [(v, n) for v in MS.VARIANTS for n in SIZES]
# the big-box sizes checked by arithmetic only (layout_pairs at 5248 atoms
# would hold 27.5M slots)
BIG_CASES = sorted({(v, min(n, MS.n_max(v))) for v in MS.VARIANTS
                    for n in (2048, MS.n_max(v))})
SM_SMEM = 233472  # shared memory of an H100 SM; 1 KB of it reserved per block
HOPPER_BLOCK = 232448  # shared memory a Hopper block can opt into


def _row_length(v, N):
    """Slots of one layout row, the ring's unit: a row of N slots (full
    rows: partner j; half shell: d - 1), or v8's shuffle step of one tile
    pair's 32 lanes."""
    return MS._TILE if v.newton == "shuffle" else N


def _tiles(lay, N):
    """(first column, width) of each column tile of a job's layout rows."""
    return [(t * lay.cols, min(lay.cols, N - t * lay.cols)) for t in range(lay.tiles)]


@pytest.mark.parametrize("variant,N", CASES)
def test_ring_layout_covers_every_slot_once_in_layout_order(variant, N):
    """The ring's stages walk each job's layout without gap or overlap:
    chunk c of a group (v8: of a tile pair) holds layout rows [r rows, (r +
    1) rows) of column tile t, c = t (chunks / tiles) + r (one tile of all N
    columns up to 512 atoms per box), so the column tiles are walked outer
    and the rows inner; the chunks of a force call cover every slot once,
    and row r holds the slots the kernel reads there, thread (lane) i at
    slot r N + i: full rows partner j = r, the half shell partner i + r + 1
    mod N, v8 step k of tile pair q with atom a 32 + l and partner b 32 +
    (l + k) mod 32.  Every job's images are copied in its group's stages,
    once per force call."""
    v = MS.VARIANTS[variant]
    lay = MS.ring_layout(v, N)
    n = _row_length(v, N)
    partner, atom = (t.numpy() for t in MS.layout_pairs(v, N))
    slots = MS.layout_slots(v, N)
    assert lay.jobs_per_group * lay.groups == v.jobs
    planes = 1 if v.unisig else 2
    jobs_per_stage = (1 if v.newton == "shuffle" else lay.jobs_per_group) if v.cache else 0
    assert lay.arrays == planes + jobs_per_stage
    o = np.arange(slots)
    if v.newton == "shuffle":
        T = N // MS._TILE
        tiles = [(a, b) for a in range(T) for b in range(a, T)]
        assert lay.chunks * lay.rows == MS._TILE and slots == len(tiles) * MS._TILE * n
        q, k, lane = o // (MS._TILE * n), (o // n) % MS._TILE, o % n
        a, b = np.array(tiles).T
        assert (atom == a[q] * MS._TILE + lane).all()
        assert (partner == b[q] * MS._TILE + (lane + k) % MS._TILE).all()
        return
    R = N if v.newton == "" else N // 2
    per = lay.chunks // lay.tiles
    assert per * lay.tiles == lay.chunks and per * lay.rows == R and slots == R * n
    assert lay.tiles == -(-N // lay.cols) and (N <= MS.SMALL_N) == (lay.cols == N)
    row, i = o // n, o % n
    assert (atom == i).all()
    assert (partner == (row if v.newton == "" else (i + row + 1) % N)).all()
    seen = np.zeros((R, n), dtype=int)
    for c in range(lay.chunks):
        t, r = divmod(c, per)
        c0, width = _tiles(lay, N)[t]
        seen[r * lay.rows:(r + 1) * lay.rows, c0:c0 + width] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("variant,N", CASES)
def test_ring_bulk_copies_are_16_byte_multiples(variant, N):
    """Every bulk copy's size, its offset in the planes and in the image
    cache of any program and job, and every stage's offset in the ring are
    multiples of 16 bytes, as cp.async.bulk requires: up to 512 atoms per
    box one copy of ``rows`` whole layout rows per array, above it one copy
    per array and row of the tile's columns."""
    v = MS.VARIANTS[variant]
    lay = MS.ring_layout(v, N)
    n = _row_length(v, N)
    slots = MS.layout_slots(v, N)
    assert lay.stage_bytes == lay.arrays * lay.rows * lay.cols * 4
    if v.newton == "shuffle" or N <= MS.SMALL_N:
        copies = [lay.rows * n * 4]
    else:
        copies = [4 * width for _, width in _tiles(lay, N)]
    assert all(c % 16 == 0 for c in copies)
    pairs = slots // (MS._TILE * n) if v.newton == "shuffle" else 1  # v8's tile pairs
    per = lay.chunks // lay.tiles
    offs = [4 * (q * MS._TILE * n + r * n + c0)
            for q in range(pairs) for r in range(per * lay.rows)
            for c0, _ in _tiles(lay, N)]
    assert all(off % 16 == 0 for off in offs)
    for prog in (0, 1, 575):
        for job in range(v.jobs):
            assert 4 * (prog * v.jobs + job) * slots % 16 == 0
    # the ring follows the 16-byte float4 positions, stage after stage
    assert lay.ring_bytes % lay.stage_bytes == 0


@pytest.mark.parametrize("variant,N", CASES)
def test_ring_shared_memory_fits_and_keeps_two_blocks(variant, N):
    """The mirrored block fits a Hopper block's 232448 bytes with a ring of
    two or three stages, and two blocks fit an SM for every one-box variant
    but v5m (the J-box variants and v5m's per-warp partials run one block
    per SM, as the first design)."""
    v = MS.VARIANTS[variant]
    lay = MS.ring_layout(v, N)
    assert lay.smem_bytes <= HOPPER_BLOCK
    assert lay.threads == MS.threads(v, N)
    warps = lay.threads // 32
    assert lay.ring_bytes == lay.depth * lay.stage_bytes * (warps if v.newton == "shuffle" else 1)
    assert 2 <= lay.depth <= MS.RING_DEPTH and lay.rows == MS.ring_rows(v, N)
    assert lay.jobs_per_group * lay.groups == v.jobs
    if v.jobs == 1 and v.newton != "partials":
        assert lay.two_blocks and 2 * (lay.smem_bytes + 1024) <= SM_SMEM


@pytest.mark.parametrize("variant", list(MS.VARIANTS))
def test_redesign_refuses_boxes_beyond_its_cap(variant):
    """Above the variant's cap (5248 atoms per box for one box, 2176 for
    v5m, 2560 for J = 2, 1280 for J = 4) the wrapper's mirror refuses the
    box before any launch, and says which cap."""
    cap = MS.n_max(variant)
    assert cap == {"v5m": 2176, "v7": 2560, "v7p": 2560, "v7d4": 1280}.get(variant, 5248)
    with pytest.raises(ValueError, match=f"up to {cap} \\(its cap\\)"):
        MS.ring_layout(variant, cap + MS.LANE)
    for bad in (0, cap - 64):  # not a positive multiple of 128
        with pytest.raises(ValueError, match="its cap"):
            MS.ring_layout(variant, bad)


@pytest.mark.parametrize("variant", list(MS.VARIANTS))
def test_redesign_runs_every_box_up_to_its_cap(variant):
    """A layout for every multiple of 128 atoms per box up to the cap, which
    takes in every box the first design runs (its shared memory within a
    Hopper block) and what the lab's 100 MiB VMEM budget admits."""
    v = MS.VARIANTS[variant]
    sizes = range(MS.LANE, MS.n_max(v) + 1, MS.LANE)
    lays = {N: MS.ring_layout(v, N) for N in sizes}
    first = [N for N in range(MS.LANE, 8192, MS.LANE) if MS.smem_bytes(v, N) <= HOPPER_BLOCK]
    assert set(first) <= set(lays)
    lab = {"v1": 3584, "v5m": 2176, "v7": 1792, "v7p": 1792, "v7d4": 1280}.get(variant, 2176)
    assert lab <= MS.n_max(v)
    for N, lay in lays.items():
        assert lay.smem_bytes <= HOPPER_BLOCK and lay.depth >= 2
        assert lay.threads == MS.threads(v, N) and lay.jobs_per_group * lay.groups == v.jobs


@pytest.mark.parametrize("variant,N", BIG_CASES)
def test_big_box_layout_arithmetic(variant, N):
    """At 2048 atoms per box and at the cap, by arithmetic only: the stages
    of a force call (chunks x rows x column widths, or v8's tile pairs x
    chunks x rows x 32 lanes) cover the job's layout slots, every copy and
    its offsets are 16-byte multiples, and the block fits."""
    v = MS.VARIANTS[variant]
    lay = MS.ring_layout(v, N)
    slots = MS.layout_slots(v, N)
    assert lay.smem_bytes <= HOPPER_BLOCK and lay.depth >= 2 and lay.rows == 4
    if v.newton == "shuffle":
        T = N // MS._TILE
        assert T * (T + 1) // 2 * lay.chunks * lay.rows * MS._TILE == slots
        assert lay.stage_bytes % 16 == 0
        return
    widths = [w for _, w in _tiles(lay, N)]
    assert sum(widths) == N and all(w % MS.LANE == 0 and w <= lay.cols for w in widths)
    assert lay.chunks // lay.tiles * lay.rows * sum(widths) == slots
    assert lay.cols % 4 == 0 and N % 4 == 0 and slots % 4 == 0  # row, column and job offsets
    assert lay.arrays == (1 if v.unisig else 2) + (lay.jobs_per_group if v.cache else 0)
    assert lay.jobs_per_group * lay.groups == v.jobs and lay.threads == lay.jobs_per_group * lay.cols


def test_both_designs_run_the_plain_version_on_the_cpu():
    """On CPU tensors slim_run and slim_run_first are slim_run_plain, and
    neither counts a launch."""
    gen = np.random.default_rng(0)
    n = 128
    pos = gen.uniform(0.0, 20.0, (n, 3))
    state = torch.as_tensor(MS.pack_state(pos, gen.normal(0, 0.004, (n, 3)), np.full(n, 14.0),
                                          np.float64))[None]
    w4e = torch.full((n, n), 0.5, dtype=torch.float64)
    sig2 = torch.full((n, n), MS.SIG2_UNIFORM, dtype=torch.float64)
    fscal = torch.as_tensor(MS.make_fscal([20.0, 20.0, 20.0, 0.0, 0.0, 0.0], [0.0] * 6))
    iscal = torch.tensor([2, 2])
    before = (MS.slim_run.launches_v5, MS.slim_run_first.launches_v5)
    ref = MS.slim_run_plain("v5", state, w4e, sig2, iscal, fscal)
    for fn in (MS.slim_run, MS.slim_run_first):
        out = fn("v5", state, w4e, sig2, iscal, fscal)
        assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert (MS.slim_run.launches_v5, MS.slim_run_first.launches_v5) == before
