"""The banded chunk's dequant and cull in the port, on the CPU.

On the card `dequant_q13`, `dequant_q16` and `build_jlist_banded` launch
the two kernels of `ops/csrc/band_cull.cu` (`dequant_boxes`,
`band_jlist`); on the CPU they take their plain versions.  Here: the
plain versions against the JAX reference on the chunks the kernels must
reproduce (a 3-atom structure, tiles with no real atom, bands past both
ends of the chunk), the boxes against a numpy spec, the routing by
device, and every argument check of the two launchers, which runs before
the device check and so on CPU tensors.  The kernels themselves are held
to these plain versions on the card (tests/test_torch_cuda.py).
"""

import jax
import numpy as np
import pytest
pytest.importorskip("torch")
import torch

from rustsasa_tpu.ops import fused_kernel as ref
from rustsasa_tpu_torch.ops import _kernels
from rustsasa_tpu_torch.ops import fused_kernel as port

PROBE = 1.4
RADII = np.array([1.4, 1.55, 1.6, 1.7, 1.8, 1.9, 2.0], np.float32)
# Tiles of padding (no real atom, tmeta (0, 0)) after the packed chunk.
PAD_TILES = 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _structures(sizes, seed, spread=25.0):
    rng = np.random.default_rng(seed)
    return [
        ((rng.uniform(0, spread, (n, 3)) + 60.0).astype(np.float32),
         rng.choice(RADII, n), np.arange(n, dtype=np.int32))
        for n in sizes
    ]


def _edge_wire(wire, seed):
    """A chunk of a 3-atom structure and two more, packed on `wire`, with
    PAD_TILES tiles of padding appended -> (numpy wire without tmeta,
    tmeta)."""
    structures = _structures([3, 300, 1000], seed=seed)
    if wire == "q13":
        wa, wb, pal, tp, tm, _ = ref._pack_structures_q13_numpy(structures,
                                                                PROBE)
        slots = PAD_TILES * ref.ATOM_TILE
        return (np.pad(wa, (0, slots)), np.pad(wb, (0, slots)), pal,
                np.pad(tp, ((0, PAD_TILES), (0, 0)))), np.pad(
                    tm, ((0, PAD_TILES), (0, 0)))
    planes4, tp, tm, _ = ref._pack_structures_q16_numpy(structures, PROBE)
    return (np.pad(planes4, ((0, 0), (0, PAD_TILES * ref.ATOM_TILE))),
            np.pad(tp, ((0, PAD_TILES), (0, 0)))), np.pad(
                tm, ((0, PAD_TILES), (0, 0)))


def _boxes_numpy(planes, qvalid):
    """The box reductions of the reference's build_jlist_banded, in
    numpy: (gmin, gmax [T, 16, 3], gmaxr [T, 16], tmin, tmax [T, 3],
    tmaxr [T])."""
    t = planes.shape[1] // ref.ATOM_TILE
    c = planes[0:3].T
    big = np.float32(3e4)
    lo = np.where(qvalid[:, None], c, big).reshape(t, 16, 8, 3).min(axis=2)
    hi = np.where(qvalid[:, None], c, -big).reshape(t, 16, 8, 3).max(axis=2)
    r = np.where(qvalid, planes[3], np.float32(0)).reshape(t, 16, 8).max(
        axis=2)
    return lo, hi, r, lo.min(axis=1), hi.max(axis=1), r.max(axis=1)


@pytest.mark.parametrize("wire", ["q13", "q16"])
def test_boxes_bit_equal_numpy(wire):
    np_wire, _tm = _edge_wire(wire, seed=1)
    dequant = getattr(port, f"dequant_boxes_{wire}")
    planes, qvalid, boxes = dequant(*port.to_device(np_wire, "cpu"))
    assert isinstance(boxes, port.Boxes)
    want = _boxes_numpy(planes.numpy(), qvalid.numpy())
    for got, w in zip(boxes, want):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      w.view(np.uint32))
    # The padding tiles: no real atom, so the far corners and r = 0.
    assert (boxes.tmin[-PAD_TILES:] == 3e4).all()
    assert (boxes.tmax[-PAD_TILES:] == -3e4).all()
    assert (boxes.tmaxr[-PAD_TILES:] == 0).all()
    # The planes and qvalid are the plain dequant's.
    plain = getattr(port, f"dequant_{wire}_reference")(
        *port.to_device(np_wire, "cpu"))
    assert torch.equal(planes, plain[0]) and torch.equal(qvalid, plain[1])


@pytest.mark.parametrize("w", [16, 24, 32, 64, 127])
@pytest.mark.parametrize("wire", ["q13", "q16"])
def test_edge_chunk_jlist_byte_equal_reference(wire, w):
    """A 3-atom structure, two tiles of padding, and bands past both ends
    of the chunk at every band width, on both wires; the builder with the
    dequant's boxes and without them gives the reference's rows."""
    np_wire, tm = _edge_wire(wire, seed=w)
    planes, qvalid, boxes = getattr(port, f"dequant_boxes_{wire}")(
        *port.to_device(np_wire, "cpu"))
    tmeta = torch.from_numpy(tm)
    got = port.build_jlist_banded(planes, qvalid, tmeta, w=w, boxes=boxes)
    want = np.asarray(jax.jit(
        lambda p, v, t: ref.build_jlist_banded(p, v, t, w=w)
    )(planes.numpy(), qvalid.numpy(), tm))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(port.build_jlist_banded(planes, qvalid, tmeta, w=w),
                       got)
    # The padding tiles admit nothing; the 3-atom structure's tile admits
    # itself.
    assert (got[-PAD_TILES:, 0] == 0).all()
    assert int(got[0, 0]) == 1 and int(got[0, 1]) & 0xFFFF == 0


def test_banded_wrappers_on_the_cpu_launch_nothing():
    np_wire, tm = _edge_wire("q13", seed=3)
    wire = port.to_device((*np_wire, tm), "cpu")
    sphere = torch.zeros((104, 4))
    sphere[:100, 3] = 1.0
    _kernels.reset_launch_counts()
    port.fused_sasa_q13_banded(*wire, sphere, n_points=100, w=16)
    assert not any(_kernels.launch_counts.values())


@pytest.mark.parametrize("name", ["dequant_q13", "dequant_q16",
                                  "dequant_boxes_q13", "dequant_boxes_q16",
                                  "build_jlist_banded"])
def test_dispatch_plain_on_cpu_refused_elsewhere(name):
    wire = {"q13": _edge_wire("q13", seed=4),
            "q16": _edge_wire("q16", seed=4)}
    q13 = port.to_device(wire["q13"][0], "cpu")
    q16 = port.to_device(wire["q16"][0], "cpu")
    planes, qvalid = port.dequant_q16_reference(*q16)
    tmeta = torch.from_numpy(wire["q16"][1])
    args, plain = {
        "dequant_q13": (q13, port.dequant_q13_reference),
        "dequant_q16": (q16, port.dequant_q16_reference),
        "dequant_boxes_q13": (q13, None),
        "dequant_boxes_q16": (q16, None),
        "build_jlist_banded": ((planes, qvalid, tmeta),
                               lambda *a: port.build_jlist_banded_reference(
                                   *a, w=16)),
    }[name]
    kw = {"w": 16} if name == "build_jlist_banded" else {}
    fn = getattr(port, name)
    got = fn(*args, **kw)
    if plain is not None:
        want = plain(*args)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g, w)
    with pytest.raises(ValueError, match="unsupported device meta"):
        fn(*(a.to("meta") for a in args), **kw)


def _q13_args(m=256):
    return [torch.zeros(m, dtype=torch.int32), torch.zeros(m, dtype=torch.int16),
            torch.zeros(256), torch.zeros((m // 128, 4))]


def _band_args(m=256):
    t = m // 128
    planes = torch.zeros((8, m))
    qvalid = torch.zeros(m, dtype=torch.bool)
    boxes = port.tile_boxes_reference(planes, qvalid)
    return [planes, qvalid, torch.zeros((t, 2), dtype=torch.int32),
            port.Boxes(*(b.contiguous() for b in boxes)), 16]


def _replace(args, i, value):
    args = list(args)
    args[i] = value
    return args


def _replace_box(args, field, value):
    args = list(args)
    args[3] = args[3]._replace(**{field: value})
    return args


@pytest.mark.parametrize("launcher, args, error, match", [
    ("dequant_q13", _replace(_q13_args(), 0, torch.zeros(256)), TypeError,
     "wire_a has dtype"),
    ("dequant_q13", _replace(_q13_args(), 1, torch.zeros(256,
                                                         dtype=torch.int32)),
     TypeError, "wire_b has dtype"),
    ("dequant_q13", _q13_args(200), ValueError, "200 slots"),
    ("dequant_q13", _replace(_q13_args(), 1, torch.zeros(128,
                                                         dtype=torch.int16)),
     ValueError, "wire_b shape"),
    ("dequant_q13", _replace(_q13_args(), 2, torch.zeros(255)), ValueError,
     "palette shape"),
    ("dequant_q13", _replace(_q13_args(), 3, torch.zeros((1, 4))),
     ValueError, "tparams shape"),
    ("dequant_q13", _replace(_q13_args(), 3, torch.zeros((4, 2)).T),
     ValueError, "contiguous"),
    ("dequant_q16", [torch.zeros((4, 256), dtype=torch.int32),
                     torch.zeros((2, 4))], TypeError, "planes4 has dtype"),
    ("dequant_q16", [torch.zeros((3, 256), dtype=torch.int16),
                     torch.zeros((2, 4))], ValueError, "planes4 shape"),
    ("dequant_q16", [torch.zeros((4, 0), dtype=torch.int16),
                     torch.zeros((0, 4))], ValueError, "0 slots"),
    ("tile_boxes", [torch.zeros((3, 256)), torch.zeros(256,
                                                       dtype=torch.bool)],
     ValueError, "planes shape"),
    ("tile_boxes", [torch.zeros((8, 256)), torch.zeros(256)], TypeError,
     "qvalid has dtype"),
    ("tile_boxes", [torch.zeros((8, 256)), torch.zeros(128,
                                                       dtype=torch.bool)],
     ValueError, "qvalid shape"),
    ("band_jlist", _replace(_band_args(), 4, 128), ValueError,
     "band width 128"),
    ("band_jlist", _replace(_band_args(), 4, 0), ValueError, "band width 0"),
    ("band_jlist", _replace(_band_args(), 2, torch.zeros((2, 2))),
     TypeError, "tmeta has dtype"),
    ("band_jlist", _replace(_band_args(), 2, torch.zeros((3, 2),
                                                         dtype=torch.int32)),
     ValueError, "tmeta shape"),
    ("band_jlist", _replace_box(_band_args(), "gmin", torch.zeros((2, 16))),
     ValueError, "gmin has shape"),
    ("band_jlist", _replace_box(_band_args(), "tmaxr", torch.zeros(3)),
     ValueError, "tmaxr shape"),
    ("band_jlist", _replace(_band_args(), 1, torch.zeros(256,
                                                         dtype=torch.uint8)),
     TypeError, "qvalid has dtype"),
], ids=lambda v: v if isinstance(v, str) else None)
def test_launcher_checks_before_any_launch(launcher, args, error, match):
    _kernels.reset_launch_counts()
    built = dict(_kernels._launchers)
    with pytest.raises(error, match=match):
        getattr(_kernels, launcher)(*args)
    assert not any(_kernels.launch_counts.values())
    assert _kernels._launchers == built


def test_launcher_slot_limit():
    # The gid plane holds slot + 1 as an exact f32: 2^24 slots and more
    # are refused (checked on the size alone, nothing is allocated).
    m = _kernels.MAX_BAND_SLOTS
    with pytest.raises(ValueError, match=f"{m} slots"):
        _kernels._band_slots(m)
    _kernels._band_slots(m - 128)


@pytest.mark.parametrize("launcher, args", [
    ("dequant_q13", _q13_args()),
    ("dequant_q16", [torch.zeros((4, 256), dtype=torch.int16),
                     torch.zeros((2, 4))]),
    ("tile_boxes", _band_args()[:2]),
    ("band_jlist", _band_args()),
])
def test_launchers_need_cuda_tensors(launcher, args):
    """Well-formed CPU tensors pass every check but the device's."""
    _kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="needs CUDA tensors, got cpu"):
        getattr(_kernels, launcher)(*args)
    assert not any(_kernels.launch_counts.values())


def test_launchers_refuse_mixed_devices():
    args = _band_args()
    args[1] = args[1].to("meta")
    with pytest.raises(ValueError, match="qvalid is on meta"):
        _kernels.band_jlist(*args)


def test_band_cull_source_builds_two_launchers():
    assert "band_cull" in _kernels.SOURCES
    assert len(_kernels.SOURCES) == 14
    for name in ("dequant_boxes", "band_jlist"):
        assert name in _kernels._SIGNATURES and name in _kernels.launch_counts
    assert _kernels.WIRES == ("q13", "q16", "planes")
    assert _kernels.MAX_BAND_W == port.JLIST_CAP == port.W_BUCKETS[-1]


@pytest.mark.parametrize("wire, boxes", [("q13", True), ("q16", False),
                                         ("planes", True)])
def test_dequant_outputs_one_buffer(wire, boxes):
    """dequant_boxes' outputs are disjoint, contiguous views of one
    allocation, each f32 view on a 64-byte boundary."""
    m, t = 384, 3
    planes, qvalid, out = _kernels._dequant_outputs(wire, m, "cpu", boxes)
    views = [] if wire == "planes" else [planes, qvalid]
    if boxes:
        assert [tuple(b.shape) for b in out] == [
            (t, 16, 3), (t, 16, 3), (t, 16), (t, 3), (t, 3), (t,)]
        views += list(out)
    else:
        assert out is None
    if wire == "planes":
        assert planes is None and qvalid is None
    else:
        assert planes.shape == (8, m) and planes.dtype == torch.float32
        assert qvalid.shape == (m,) and qvalid.dtype == torch.bool
    base = views[0].untyped_storage().data_ptr()
    spans = []
    for v in views:
        assert v.is_contiguous()
        assert v.untyped_storage().data_ptr() == base
        start = v.data_ptr() - base
        if v.dtype == torch.float32:
            assert start % 64 == 0
        spans.append((start, start + v.numel() * v.element_size()))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] <= views[0].untyped_storage().nbytes()
