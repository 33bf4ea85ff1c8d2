"""P1's Hopper redesign (scema_tpu_torch.ops.md_slim, csrc/md_slim_ring.cu)
on the CPU: ``ring_layout``, the wrapper's mirror of the kernel's block,
which sizes each launch (chip_smoke.py phase 18 holds it, field for field,
against the kernel's own), against the variant's slot layout
(``layout_pairs``, which lays out the planes the ring copies).  No GPU and
no JAX: the kernel itself runs only on the card (chip_smoke.py phase 18,
whose bit-for-bit check against the first design covers the copies'
offsets); the plain version against the lab's ``run_slim`` is
tests/test_torch_probe_allpairs.py.
"""
import numpy as np
import pytest
import torch

from scema_tpu_torch.ops import md_slim as MS

SIZES = (128, 256, 512)
CASES = [(v, n) for v in MS.VARIANTS for n in SIZES]
SM_SMEM = 233472  # shared memory of an H100 SM; 1 KB of it reserved per block


def _row_length(v, N):
    """Slots of one layout row, the ring's unit: a row of N slots (full
    rows: partner j; half shell: d - 1), or v8's shuffle step of one tile
    pair's 32 lanes."""
    return MS._TILE if v.newton == "shuffle" else N


@pytest.mark.parametrize("variant,N", CASES)
def test_ring_layout_covers_every_slot_once_in_layout_order(variant, N):
    """The ring's stages walk each job's layout from slot 0 to the last in
    whole rows, without gap or overlap: chunk c of a group (v8: of a tile
    pair) holds layout rows [c rows, (c + 1) rows), the chunks of a force
    call cover every row once, and row r holds the slots the kernel reads
    there, thread (lane) i at slot r N + i: full rows partner j = r, the
    half shell partner i + r + 1 mod N, v8 step k of tile pair q with atom
    a 32 + l and partner b 32 + (l + k) mod 32.  Every job's images are
    copied in its group's stages, once per force call."""
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
    assert lay.chunks * lay.rows == R and slots == R * n
    row, i = o // n, o % n
    assert (atom == i).all()
    assert (partner == (row if v.newton == "" else (i + row + 1) % N)).all()
    seen = np.zeros(slots, dtype=int)
    for c in range(lay.chunks):
        seen[c * lay.rows * n:(c + 1) * lay.rows * n] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("variant,N", CASES)
def test_ring_bulk_copies_are_16_byte_multiples(variant, N):
    """Every bulk copy's size, its offset in the planes and in the image
    cache of any program and job, and every stage's offset in the ring are
    multiples of 16 bytes, as cp.async.bulk requires."""
    v = MS.VARIANTS[variant]
    lay = MS.ring_layout(v, N)
    n = _row_length(v, N)
    slots = MS.layout_slots(v, N)
    copy = lay.rows * n * 4
    assert copy % 16 == 0 and lay.stage_bytes == lay.arrays * copy
    pairs = slots // (MS._TILE * n) if v.newton == "shuffle" else 1  # v8's tile pairs
    offs = [4 * (q * MS._TILE * n + c * lay.rows * n)
            for q in range(pairs) for c in range(lay.chunks)]
    assert all(off % 16 == 0 for off in offs)
    for prog in (0, 1, 575):
        for job in range(v.jobs):
            assert 4 * (prog * v.jobs + job) * slots % 16 == 0
    # the ring follows the 16-byte float4 positions, stage after stage
    assert lay.ring_bytes % lay.stage_bytes == 0


@pytest.mark.parametrize("variant,N", CASES)
def test_ring_shared_memory_fits_and_keeps_two_blocks(variant, N):
    """The mirrored block fits a Hopper block's 232448 bytes, and two
    blocks fit an SM for every one-box variant but v5m (the J-box variants
    and v5m's per-warp partials run one block per SM, as the first
    design)."""
    v = MS.VARIANTS[variant]
    lay = MS.ring_layout(v, N)
    assert lay.smem_bytes <= 232448
    assert lay.threads == MS.threads(v, N)
    warps = lay.threads // 32
    assert lay.ring_bytes == lay.depth * lay.stage_bytes * (warps if v.newton == "shuffle" else 1)
    assert 1 <= lay.depth <= MS.RING_DEPTH and lay.rows == MS.ring_rows(v)
    assert lay.jobs_per_group * lay.groups == v.jobs
    if v.jobs == 1 and v.newton != "partials":
        assert lay.two_blocks and 2 * (lay.smem_bytes + 1024) <= SM_SMEM


@pytest.mark.parametrize("variant", list(MS.VARIANTS))
def test_redesign_refuses_boxes_beyond_its_block(variant):
    """The redesign keeps a thread's atoms in its registers, so a box holds
    at most the block width of atoms (640 is beyond it for every variant);
    the wrapper's mirror says so before any launch."""
    with pytest.raises(ValueError, match="atoms per box"):
        MS.ring_layout(variant, 640)


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
