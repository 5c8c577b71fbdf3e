"""Parity of the PyTorch port's fused path with the JAX reference (CPU).

The same numpy inputs, made from a seed, go through
`rustsasa_tpu.ops.fused_kernel` (Pallas in interpret mode) and
`rustsasa_tpu_torch.ops.fused_kernel` (plain torch on the CPU).  Every
comparison is exact: the port keeps the reference's operation order, so
packers, dequantized planes, j-lists and counts agree byte for byte (counts
at every real atom slot).  The CUDA kernel itself is held against the same
plain-torch version on the card (tests/test_torch_cuda.py).
"""

import inspect

import jax
import numpy as np
import pytest
pytest.importorskip("torch")
import torch

from rustsasa_tpu.ops import fused_kernel as ref
from rustsasa_tpu.ops.engine import _sphere_packed as ref_sphere_packed
from rustsasa_tpu_torch.ops import _kernels
from rustsasa_tpu_torch.ops import fused_kernel as port

PROBE = 1.4
RADII = np.array([1.4, 1.55, 1.6, 1.7, 1.8, 1.9, 2.0], np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and each process's spinning OpenMP threads would fight the
    others' for the same cores (a 1 s test took 300 s that way)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _structures(sizes, seed, spread=25.0):
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        coords = (rng.uniform(0, spread, (n, 3)) + 60.0).astype(np.float32)
        radii = rng.choice(RADII, n)
        out.append((coords, radii, np.arange(n, dtype=np.int32)))
    return out


def _real_slots(offsets, m):
    real = np.zeros(m, dtype=bool)
    for pos, n, _inv in offsets:
        real[pos:pos + n] = True
    return real


def _sphere128(n_points):
    packed = ref_sphere_packed(n_points)
    s128 = np.zeros((packed.shape[0], 128), np.float32)
    s128[:, 0:4] = packed
    return packed, s128


def _jax_jlist(planes, qvalid, tmeta, w):
    return np.asarray(
        jax.jit(lambda p, v, t: ref.build_jlist_banded(p, v, t, w=w))(
            planes, qvalid, tmeta
        )
    )


@pytest.mark.parametrize(
    "name", ["_pack_structures_q13_numpy", "_pack_structures_q16_numpy",
             "_morton_codes", "_pack_structures_numpy", "quantize_packed"],
)
def test_packer_copies_pinned_to_reference(name):
    # The numpy packers are copied (the reference module imports JAX);
    # any drift between the two copies fails here.
    assert inspect.getsource(getattr(port, name)) == inspect.getsource(
        getattr(ref, name)
    )


@pytest.mark.parametrize("wire", ["q13", "q16"])
def test_packers_byte_equal_reference_and_native(wire):
    structures = _structures([3, 100, 128, 700, 1500], seed=1)
    numpy_ref = getattr(ref, f"_pack_structures_{wire}_numpy")(
        structures, PROBE
    )
    numpy_port = getattr(port, f"_pack_structures_{wire}_numpy")(
        structures, PROBE
    )
    native_port = getattr(port, f"pack_structures_{wire}")(structures, PROBE)
    for got in (numpy_port, native_port):
        assert len(got) == len(numpy_ref)
        for a, b in zip(got[:-1], numpy_ref[:-1]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        for oa, ob in zip(got[-1], numpy_ref[-1]):
            assert oa[0] == ob[0] and oa[1] == ob[1]
            np.testing.assert_array_equal(oa[2], ob[2])


def test_dequant_q13_bit_equal_numpy():
    wa, wb, pal, tp, tm, offsets = ref._pack_structures_q13_numpy(
        _structures([90, 400], seed=2), PROBE
    )
    planes, qvalid = port.dequant_q13(*port.to_device((wa, wb, pal, tp), "cpu"))
    # numpy evaluation of the reference's dequant (fused_sasa_q13_banded).
    a = wa.astype(np.uint32)
    b = wb.astype(np.uint32)
    q = [
        (a & 0x1FFF).astype(np.float32),
        ((a >> 13) & 0x1FFF).astype(np.float32),
        ((((a >> 26) & 0x3F) << 7) | (b & 0x7F)).astype(np.float32),
    ]
    ridx = (b >> 7) & 0xFF
    par = np.repeat(tp, ref.ATOM_TILE, axis=0)
    want = np.zeros((ref.N_PLANES, wa.shape[0]), np.float32)
    for axis in range(3):
        want[axis] = q[axis] * par[:, 3] + par[:, axis]
    want[3] = pal[ridx]
    slot_gid = np.arange(wa.shape[0], dtype=np.float32) + 1.0
    want[4] = np.where(ridx > 0, slot_gid, 0.0)
    np.testing.assert_array_equal(planes.numpy().view(np.uint32),
                                  want.view(np.uint32))
    np.testing.assert_array_equal(qvalid.numpy(), ridx > 0)


def test_dequant_q16_bit_equal_numpy():
    planes4, tp, tm, offsets = ref._pack_structures_q16_numpy(
        _structures([90, 400], seed=3, spread=150.0), PROBE
    )
    planes, qvalid = port.dequant_q16(*port.to_device((planes4, tp), "cpu"))
    # numpy evaluation as in tests/test_pallas.py (banded cull test).
    q = planes4.astype(np.float32)
    par = np.repeat(tp, ref.ATOM_TILE, axis=0)
    want = np.zeros((ref.N_PLANES, planes4.shape[1]), np.float32)
    want[0] = q[0] * par[:, 3] + par[:, 0]
    want[1] = q[1] * par[:, 3] + par[:, 1]
    want[2] = q[2] * par[:, 3] + par[:, 2]
    want[3] = q[3] * np.float32(1.0 / ref.R_QUANT)
    want[4] = np.where(q[3] > 0, np.arange(q.shape[1], dtype=np.float32) + 1, 0)
    np.testing.assert_array_equal(planes.numpy().view(np.uint32),
                                  want.view(np.uint32))
    np.testing.assert_array_equal(qvalid.numpy(), q[3] > 0)


@pytest.mark.parametrize("w", [16, 24, 32, 64, 127])
def test_jlist_byte_equal_reference(w):
    # Every band width the engine picks.  5,200 atoms = 41 tiles: with
    # w=64 one band covers a whole structure; 9,000 atoms = 71 tiles take
    # w=127, whose nd = 253 offsets overflow the row (JLIST_CAP = 127), so
    # the sorted tail is cut.
    sizes = {64: [300, 5200], 127: [300, 9000]}.get(w, [64, 700, 1000])
    planes4, tp, tm, offsets = ref._pack_structures_q16_numpy(
        _structures(sizes, seed=w, spread=35.0), PROBE
    )
    planes, qvalid = port.dequant_q16(*port.to_device((planes4, tp), "cpu"))
    got = port.build_jlist_banded(planes, qvalid, torch.from_numpy(tm), w=w)
    want = _jax_jlist(planes.numpy(), qvalid.numpy(), tm, w)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # Some entries carry mask bit 15, i.e. are negative as int32.
    assert (got.numpy()[:, 1:] < 0).any()
    # The rows' tails hold the offsets past the chunk's ends, whose boxes
    # are the zero padding (the tile field, as a signed 16-bit j, lies
    # outside [0, T)), with the masks computed against those zeros.
    t = tm.shape[0]
    ent = got.numpy()[:, 1:].astype(np.int64) & 0xFFFFFFFF
    j = ((ent & 0xFFFF) ^ 0x8000) - 0x8000
    outside = (j < 0) | (j >= t)
    assert outside.any() and (ent[outside] >> 16 != 0).any()
    # Columns past the band's nd offsets stay 0.
    nd = 2 * w - 1
    assert not got.numpy()[:, 1 + min(nd, ref.JLIST_CAP):].any()


def test_jlist_never_culls_true_neighbors():
    """Every atom pair close enough to occlude has j's 8-atom group
    admitted into i's tile j-list (the check of tests/test_pallas.py)."""
    planes4, tp, tm, offsets = ref._pack_structures_q16_numpy(
        _structures([64, 333, 1000], seed=40, spread=12.0), PROBE
    )
    planes, qvalid = port.dequant_q16(*port.to_device((planes4, tp), "cpu"))
    jlist = port.build_jlist_banded(
        planes, qvalid, torch.from_numpy(tm), w=32
    ).numpy().astype(np.int64) & 0xFFFFFFFF
    planes = planes.numpy()
    for pos, n, _inv in offsets:
        c = planes[0:3, pos:pos + n].T
        reff = planes[3, pos:pos + n]
        d = np.linalg.norm(c[:, None, :] - c[None, :, :], axis=-1)
        ii, jj = np.nonzero(d < (reff[:, None] + reff[None, :]))
        for a, b in zip(ii, jj):
            ti = (pos + a) // ref.ATOM_TILE
            tj = (pos + b) // ref.ATOM_TILE
            gj = ((pos + b) % ref.ATOM_TILE) // ref.J_GROUP
            entries = jlist[ti, 1:1 + jlist[ti, 0]]
            match = entries[(entries & 0xFFFF) == tj]
            assert match.size == 1, (ti, tj)
            assert (int(match[0]) >> 16) & (1 << gj), (ti, tj, gj)
    assert jlist[:, 0].max() <= ref.JLIST_CAP


@pytest.mark.parametrize("n_points", [60, 100])
def test_counts_reference_byte_equal_pallas(n_points, monkeypatch):
    # Small blocks: the plain version walks its j-atoms in many chunks.
    monkeypatch.setitem(port.REFERENCE_BLOCK_ELEMS, "cpu", 1 << 16)
    wa, wb, pal, tp, tm, offsets = ref._pack_structures_q13_numpy(
        _structures([150, 600], seed=5), PROBE
    )
    planes, qvalid = port.dequant_q13(*port.to_device((wa, wb, pal, tp), "cpu"))
    jlist = port.build_jlist_banded(planes, qvalid, torch.from_numpy(tm), w=16)
    packed, s128 = _sphere128(n_points)
    got = port.fused_counts_reference(
        planes, jlist, torch.from_numpy(packed)
    ).numpy()
    want = np.asarray(
        ref._counts_call(planes.numpy(), jlist.numpy(), s128, interpret=True)
    ).reshape(-1)
    real = _real_slots(offsets, wa.shape[0])
    np.testing.assert_array_equal(got[real], want[real].astype(np.int32))
    # fused_counts routes CPU tensors to the plain version.
    np.testing.assert_array_equal(
        port.fused_counts(planes, jlist, torch.from_numpy(packed)).numpy(),
        port.fused_counts_reference(planes, jlist, torch.from_numpy(packed))
        .numpy(),
    )


@pytest.mark.parametrize("n_points", [60, 100, 256])
def test_fused_sasa_q13_byte_equal_reference(n_points):
    structures = _structures([100, 300, 700], seed=6)
    # A same-gid case: coincident atoms with distinct ids occlude each
    # other, while an atom's own (coincident) slot is masked by its gid.
    structures[0][0][1] = structures[0][0][0]
    wa, wb, pal, tp, tm, offsets = ref._pack_structures_q13_numpy(
        structures, PROBE
    )
    packed, s128 = _sphere128(n_points)
    want = np.asarray(ref.fused_sasa_q13_banded(
        wa, wb, pal, tp, tm, s128, n_points=n_points, w=16, interpret=True
    ))
    got = port.fused_sasa_q13_banded(
        *port.to_device((wa, wb, pal, tp, tm), "cpu"),
        torch.from_numpy(packed), n_points=n_points, w=16,
    ).numpy()
    if n_points > 255:
        got = got.view(np.uint16)
    assert got.dtype == want.dtype == (np.uint8 if n_points <= 255
                                       else np.uint16)
    real = _real_slots(offsets, wa.shape[0])
    np.testing.assert_array_equal(got[real], want[real])


@pytest.mark.parametrize("n_points", [100, 256])
def test_fused_sasa_q16_byte_equal_reference(n_points):
    structures = _structures([200, 900], seed=7, spread=130.0)
    planes4, tp, tm, offsets = ref._pack_structures_q16_numpy(
        structures, PROBE
    )
    packed, s128 = _sphere128(n_points)
    want = np.asarray(ref.fused_sasa_q16_banded(
        planes4, tp, tm, s128, n_points=n_points, w=16, interpret=True
    ))
    got = port.fused_sasa_q16_banded(
        *port.to_device((planes4, tp, tm), "cpu"),
        torch.from_numpy(packed), n_points=n_points, w=16,
    ).numpy()
    if n_points > 255:
        got = got.view(np.uint16)
    real = _real_slots(offsets, planes4.shape[1])
    np.testing.assert_array_equal(got[real], want[real])


def test_fused_counts_rejects_other_devices():
    planes = torch.zeros((8, 128), device="meta")
    with pytest.raises(ValueError):
        port.fused_counts(planes, planes, planes)


def test_kernel_wrapper_refuses_cpu_tensors():
    # The CUDA wrapper never runs the plain version itself.
    planes = torch.zeros((8, 128))
    jlist = torch.zeros((1, 128), dtype=torch.int32)
    sphere = torch.zeros((104, 4))
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.fused_count(planes, jlist, sphere)


def _host_cull_wire(seed=8):
    """Host-cull packing of a small chunk with one shared group id, and
    its j-list edited to carry a full 127-entry row of 0xFFFF masks
    (negative as int32) over repeated tiles."""
    structures = _structures([150, 420, 300], seed=seed, spread=20.0)
    gids = structures[1][2].copy()
    gids[5] = gids[4]
    structures[1] = (structures[1][0], structures[1][1], gids)
    planes, jlist, offsets, failed = ref._pack_structures_numpy(
        structures, PROBE, 100
    )
    assert failed == []
    t = jlist.shape[0]
    jlist = jlist.copy()
    jlist[0, 0] = ref.JLIST_CAP
    jlist[0, 1:] = (np.uint32(0xFFFF) << np.uint32(16)) | (
        np.arange(ref.JLIST_CAP, dtype=np.uint32) % np.uint32(t)
    )
    return structures, planes, jlist, offsets


def test_host_cull_packers_byte_equal_reference_and_native():
    structures = _structures([3, 100, 128, 700, 1500], seed=9)
    gids = structures[3][2].copy()
    gids[10] = gids[11]  # shared ids ride the f32 planes
    structures[3] = (structures[3][0], structures[3][1], gids)
    want = ref._pack_structures_numpy(structures, PROBE, 100)
    for got in (port._pack_structures_numpy(structures, PROBE, 100),
                port.pack_structures(structures, PROBE, 100)):
        for a, b in zip(got[:2], want[:2]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        for oa, ob in zip(got[2], want[2]):
            assert oa[0] == ob[0] and oa[1] == ob[1]
            np.testing.assert_array_equal(oa[2], ob[2])
        assert got[3] == want[3] == []
    spans = [(o[0], o[1]) for o in want[2]]
    q_ref = ref.quantize_packed(want[0], spans)
    q_port = port.quantize_packed(want[0], spans)
    for a, b in zip(q_port, q_ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # Past 1,300 A the quantizer refuses, on both sides.
    far = want[0].copy()
    far[0, spans[1][0]] += 2000.0
    assert port.quantize_packed(far, spans) is None
    assert ref.quantize_packed(far, spans) is None


@pytest.mark.parametrize("n_points", [100, 256])
def test_fused_sasa_f32_byte_equal_reference(n_points):
    structures, planes, jlist, offsets = _host_cull_wire()
    packed, s128 = _sphere128(n_points)
    want = np.asarray(ref.fused_sasa(
        planes, jlist, s128, n_points=n_points, out_dtype=np.float32,
        interpret=True,
    ))
    got = port.fused_sasa(
        *port.to_device((planes, jlist), "cpu"), torch.from_numpy(packed),
        n_points=n_points,
    ).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert (got[_real_slots(offsets, got.shape[0])] > 0).any()


@pytest.mark.parametrize("n_points", [100, 256])
def test_fused_sasa_q16_counts_byte_equal_reference(n_points):
    structures, planes, jlist, offsets = _host_cull_wire(seed=10)
    spans = [(o[0], o[1]) for o in offsets]
    planes4, tparams = port.quantize_packed(planes, spans)
    packed, s128 = _sphere128(n_points)
    wire = port.to_device((planes4, tparams, jlist), "cpu")
    got = port.fused_sasa_q16(
        *wire, torch.from_numpy(packed), n_points=n_points
    ).numpy()
    if n_points > 255:
        got = got.view(np.uint16)
    # The reference's counts on the same dequantized planes and j-lists
    # (the port's dequant is pinned to the numpy spec above).
    deq, _ = port.dequant_q16(*wire[:2])
    want = np.asarray(ref._counts_call(
        deq.numpy(), jlist, s128, interpret=True
    )).reshape(-1)
    real = _real_slots(offsets, got.shape[0])
    assert got.dtype == (np.uint8 if n_points <= 255 else np.uint16)
    np.testing.assert_array_equal(got[real], want[real].astype(got.dtype))


def test_reference_host_cull_dequant_is_fused_on_xla_cpu():
    """Why the host-cull q16 wire is compared on identical planes: inside
    the reference's `fused_sasa_q16` jit, XLA-CPU contracts
    q * scale + origin into one fused multiply-add, where the reference's
    source (and the port) round the multiply and the add separately."""
    _, planes, _, offsets = _host_cull_wire(seed=11)
    planes4, tparams = ref.quantize_packed(
        planes, [(o[0], o[1]) for o in offsets]
    )
    q = planes4[0].astype(np.float64)
    par = np.repeat(tparams, ref.ATOM_TILE, axis=0).astype(np.float64)
    fused = (q * par[:, 3] + par[:, 0]).astype(np.float32)
    separate = (planes4[0].astype(np.float32) * tparams.repeat(
        ref.ATOM_TILE, axis=0)[:, 3]) + tparams.repeat(
        ref.ATOM_TILE, axis=0)[:, 0]
    xla = np.asarray(jax.jit(
        lambda p4, tp: p4.astype(np.float32)
        * jax.numpy.repeat(tp, ref.ATOM_TILE, axis=0)[:, 3]
        + jax.numpy.repeat(tp, ref.ATOM_TILE, axis=0)[:, 0]
    )(planes4[0], tparams))
    port_x = port.dequant_q16(*port.to_device((planes4, tparams), "cpu"))[0]
    np.testing.assert_array_equal(port_x[0].numpy(), separate)
    np.testing.assert_array_equal(xla, fused)
    assert (fused != separate).any()
