"""The port's scale-out layer (``parallel/screen``: the mesh, the sharded
library and profile screens, the grid, the checkpointed screen over a
mesh) against the JAX package on its 8 virtual CPU devices, on the same
seeded inputs: every array bit-equal (float32 compared as bits).  A mesh
on the CPU names the CPU once per entry; its shards run one after
another.  Also the repair of ROADMAP C6: a bucket past K3's shared-memory caps on
the host-build route is scored on K7."""

import io
import os
import sys

import numpy as np
import pytest
import torch

from alignment_algos_tpu.parallel import checkpoint as jcheckpoint
from alignment_algos_tpu.parallel import screen as jscreen
from alignment_algos_tpu_torch.parallel import screen
from alignment_algos_tpu_torch.parallel.checkpoint import (
    screen_library_checkpointed)

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
INP = os.path.join(ROOT, "tests", "golden", "inputs")


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def _same(got, want) -> None:
    """Equal dtype and shape, float32 compared as bits."""
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == np.float32:
        got, want = _bits(got), _bits(want)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def library():
    """tests/test_parallel.py's inputs, pad-walled, with five duplicated
    templates (score ties across shards)."""
    rng = np.random.default_rng(0)
    q = rng.integers(0, 20, 48).astype(np.int32)
    lib = rng.integers(0, 20, (37, 56)).astype(np.int32)
    for r, n in enumerate(rng.integers(20, 56, 37)):
        lib[r, n:] = 20
    lib = np.concatenate([lib[:5], lib[:5], lib[5:]], axis=0)
    table = np.full((21, 21), -1.0e4, np.float32)
    table[:20, :20] = rng.integers(-4, 11, (20, 20))
    return q, lib, table


# ----------------------------------------------------------------- mesh

def test_mesh_mirrors_the_jax_mesh():
    mesh = screen.grid_mesh((2, 4), device=CPU)
    jmesh = jscreen.grid_mesh((2, 4))
    assert mesh.devices.shape == jmesh.devices.shape
    assert mesh.shape == dict(jmesh.shape) == {"qb": 2, "lib": 4}
    assert mesh.size == jmesh.devices.size == 8
    assert mesh.axis_names == jmesh.axis_names
    assert all(d == CPU for d in mesh.devices.flat)
    assert screen.default_mesh(device=CPU).size == 1
    with pytest.raises(ValueError):
        screen.Mesh([CPU, CPU], ("a", "b"))


@pytest.mark.parametrize("make", [
    lambda: screen.default_mesh(2, device="cuda"),
    lambda: screen.grid_mesh((1, 2), device="cuda"),
], ids=["default_mesh", "grid_mesh"])
def test_mesh_of_more_cards_than_visible_raises(make, monkeypatch):
    """No drop to CPU entries: asking for more cards than are visible
    raises (here none is)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="visible cards"):
        make()


@pytest.mark.parametrize("n,k", [(1, 12), (2, 12), (4, 7), (8, 12),
                                 (8, 42)])
def test_sharded_screen_equals_jax(library, n, k):
    """screen_library over n CPU entries == the JAX screen over n virtual
    devices == the port's one-device screen; the duplicated templates tie
    and the lower index ranks first."""
    q, lib, table = library
    s, i = screen.screen_library(q, lib, table, 11.0, 1.0, k=k,
                                 mesh=screen.default_mesh(n, device=CPU))
    assert s.dtype == np.float32 and i.dtype == np.int32 and len(i) == k
    js, ji = jscreen.screen_library(q, lib, table, 11.0, 1.0, k=k,
                                    mesh=jscreen.default_mesh(n))
    os_, oi = screen.screen_library(q, lib, table, 11.0, 1.0, k=k,
                                    device=CPU)
    for ws, wi in ((js, ji), (os_, oi)):
        np.testing.assert_array_equal(i, wi)
        np.testing.assert_array_equal(_bits(s), _bits(ws))
    pos = {int(x): r for r, x in enumerate(i)}
    for r in range(5):
        if r in pos and r + 5 in pos:
            assert pos[r] < pos[r + 5] and s[pos[r]] == s[pos[r + 5]]


def test_merge_topk_orders_ties_by_index():
    s = np.array([[3.0, 5.0, 5.0, 0.0, 5.0]], np.float32)
    i = np.array([[4, 9, 2, 0, 7]])
    ms, mi = screen.merge_topk(s, i, 4)
    np.testing.assert_array_equal(mi, [[2, 7, 9, 4]])
    np.testing.assert_array_equal(ms, [[5.0, 5.0, 5.0, 3.0]])
    assert screen.shard_bounds(3, 8) == [(0, 1), (1, 2), (2, 3)] + \
        [(3, 3)] * 5


def _gotoh_scores(q, lib, pad: int, table, gi: float, ge: float):
    """Every template's best local score by the plain affine Gotoh
    recurrence in float64 torch (a gap of k costs gi + (k - 1) ge), lanes
    the templates, over each template's real residues only."""
    t = torch.from_numpy(lib).long().clamp(max=pad - 1)
    lens = torch.from_numpy((lib != pad).sum(axis=1))
    n, tmax = t.shape
    sub = torch.from_numpy(table[:pad, :pad]).double()
    real = torch.arange(tmax)[None, :] < lens[:, None]
    ninf = torch.tensor(float("-inf"), dtype=torch.float64)
    h_up = torch.zeros(n, tmax + 1, dtype=torch.float64)
    f = ninf.expand(n, tmax)
    best = torch.zeros(n, dtype=torch.float64)
    for qi in q:
        s = sub[int(qi)][t]
        f = torch.maximum(f - ge, h_up[:, 1:] - gi)
        h = torch.zeros(n, tmax + 1, dtype=torch.float64)
        e = ninf.expand(n)
        for j in range(tmax):
            e = torch.maximum(e - ge, h[:, j] - gi)
            h[:, j + 1] = torch.maximum(torch.maximum(
                h_up[:, j] + s[:, j], e), f[:, j]).clamp(min=0.0)
        best = torch.maximum(best, torch.where(real, h[:, 1:], 0.0).amax(1))
        h_up = h
    return best.numpy()


@pytest.mark.parametrize("k", [5, 23])
def test_four_shards_of_uneven_size_and_length_equal_one_device(k):
    """23 templates over four CPU entries (shards of 6, 6, 6 and 5), each
    shard's longest template a different length: the hits equal the
    one-device screen's bit for bit, and a plain Gotoh's."""
    rng = np.random.default_rng(23)
    n, pad = 23, 20
    q = rng.integers(0, 20, 30).astype(np.int32)
    lens = rng.integers(10, 20, n)
    lens[[0, 6, 12, 18]] = [47, 40, 33, 26]
    lib = np.full((n, 47), pad, np.int32)
    for r, m in enumerate(lens):
        lib[r, :m] = rng.integers(0, 20, m)
    lib[7, 3:23] = q[5:25]                      # a homolog in shard 1
    lib[20] = lib[7]                            # its tie in shard 3
    table = np.full((21, 21), -1.0e4, np.float32)
    table[:20, :20] = rng.integers(-4, 3, (20, 20))
    np.fill_diagonal(table[:20, :20], 6)
    bounds = screen.shard_bounds(n, 4)
    assert [hi - lo for lo, hi in bounds] == [6, 6, 6, 5]
    assert len({int(lens[lo:hi].max()) for lo, hi in bounds}) == 4

    s, i = screen.screen_library(q, lib, table, 11.0, 1.0, k=k,
                                 mesh=screen.default_mesh(4, device=CPU))
    os_, oi = screen.screen_library(q, lib, table, 11.0, 1.0, k=k,
                                    device=CPU)
    _same(s, os_)
    _same(i, oi)
    want = _gotoh_scores(q, lib, pad, table, 11.0, 1.0)
    top = np.lexsort((np.arange(n), -want))[:k]
    np.testing.assert_array_equal(i, top)
    _same(s, want[top].astype(np.float32))
    assert list(i[:2]) == [7, 20] and s[0] == s[1]


# ----------------------------------------------------------------- grid

@pytest.mark.parametrize("k", [5, 42])
def test_grid_2x4_equals_jax(library, k):
    """All three arrays of screen_grid on a (2, 4) mesh bit-equal to the
    JAX screen_grid's on its (2, 4) mesh, and to the default (1, 1)
    mesh's; each row's top k is the one-query screen's."""
    q, lib, table = library
    qs = np.stack([q, (q + 1) % 20, (q + 5) % 20])
    got = screen.screen_grid(qs, lib, table, 4.73, 0.34, k=k,
                             mesh=screen.grid_mesh((2, 4), device=CPU))
    want = jscreen.screen_grid(qs, lib, table, 4.73, 0.34, k=k,
                               mesh=jscreen.grid_mesh((2, 4)))
    one = screen.screen_grid(qs, lib, table, 4.73, 0.34, k=k, device=CPU)
    for other in (want, one):
        for g, w in zip(got, other):
            _same(g, w)
    for r in range(len(qs)):
        s, i = screen.screen_library(qs[r], lib, table, 4.73, 0.34,
                                     k=k, device=CPU)
        np.testing.assert_array_equal(got[2][r], i)
        np.testing.assert_array_equal(_bits(got[1][r]), _bits(s))


def test_grid_blocks_run_in_few_launches(library, monkeypatch):
    """A block's queries share K1 launches (its per-lane form), at most
    GRID_LANES lanes each: here one launch for each of the 2 query blocks
    x 4 library shards (11, 11, 11 and 9 templates), and one a query when
    two queries do not fit."""
    q, lib, table = library
    qs = np.stack([q, (q + 1) % 20, (q + 5) % 20, (q + 7) % 20])
    lanes = []
    real = screen.swaffine.sw_affine_scores

    def spy(qc, tc, *a):
        assert qc.dim() == 2 and qc.shape[1] == tc.shape[1]
        lanes.append(tc.shape[1])
        return real(qc, tc, *a)

    monkeypatch.setattr(screen.swaffine, "sw_affine_scores", spy)
    want = screen.screen_grid(qs, lib, table, 11.0, 1.0, k=3,
                              mesh=screen.grid_mesh((1, 1), device=CPU))
    assert lanes == [4 * len(lib)]
    for cap, per_block in ((22, [22, 22, 22, 18]),
                           (21, [11, 11, 11, 11, 11, 11, 18])):
        monkeypatch.setattr(screen, "GRID_LANES", cap)
        lanes.clear()
        got = screen.screen_grid(qs, lib, table, 11.0, 1.0, k=3,
                                 mesh=screen.grid_mesh((2, 4), device=CPU))
        assert lanes == per_block * 2
        for g, w in zip(got, want):
            _same(g, w)


# ------------------------------------------------------ checkpointed screen

def test_checkpointed_screen_over_a_mesh_equals_jax(library, tmp_path):
    q, lib, table = library
    ck = str(tmp_path / "port.npz")
    mesh = screen.default_mesh(8, device=CPU)
    s, i, done = screen_library_checkpointed(
        q, lib, table, 11.0, 1.0, k=12, chunk_size=10, ckpt_path=ck,
        mesh=mesh, max_chunks=2)
    assert not done
    s, i, done = screen_library_checkpointed(
        q, lib, table, 11.0, 1.0, k=12, chunk_size=10, ckpt_path=ck,
        mesh=mesh)
    assert done
    js, ji, jdone = jcheckpoint.screen_library_checkpointed(
        q, lib, table, 11.0, 1.0, k=12, chunk_size=10,
        ckpt_path=str(tmp_path / "jax.npz"), mesh=jscreen.default_mesh(8))
    assert jdone
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_array_equal(_bits(s), _bits(js))


# -------------------------------------------------------- profile screens

def _hmap_pair(files, directory=INP):
    from alignment_algos_tpu.seq.hmap import HMAPSequence
    from alignment_algos_tpu_torch.seq.hmap import (
        HMAPSequence as THMAPSequence)
    paths = [os.path.join(directory, f) for f in files]
    return ([HMAPSequence.from_file(p) for p in paths],
            [THMAPSequence.from_file(p) for p in paths])


@pytest.mark.parametrize("n", [2, 8])
def test_profile_screen_sharded_equals_jax(n):
    """HMAPaliEval over a mesh takes the host build (as the JAX package
    routes it): bit-equal to the JAX sharded screen and to the port's
    unsharded (device-similarity) screen."""
    from alignment_algos_tpu.scoring.hmap_eval import HMAPaliEval
    from alignment_algos_tpu.utils.params import HMAPaliParams
    from alignment_algos_tpu_torch.scoring.hmap_eval import (
        HMAPaliEval as THMAPaliEval)
    from alignment_algos_tpu_torch.utils.params import (
        HMAPaliParams as THMAPaliParams)
    (jq, *jts), (q, *ts) = _hmap_pair(
        ("qA.prof", "tA.prof", "tB.prof", "qB.prof"))
    jp, tp = HMAPaliParams(), THMAPaliParams()
    js, jo = jscreen.screen_profiles(jq, jts, lambda a, b: HMAPaliEval(jp),
                                     k=3, mesh=jscreen.default_mesh(n))
    s, o = screen.screen_profiles(q, ts, lambda a, b: THMAPaliEval(tp),
                                  k=3, device=CPU,
                                  mesh=screen.default_mesh(n, device=CPU))
    os_, oo = screen.screen_profiles(q, ts, lambda a, b: THMAPaliEval(tp),
                                     k=3, device=CPU)
    for ws, wo in ((js, jo), (os_, oo)):
        np.testing.assert_array_equal(_bits(s), _bits(ws))
        np.testing.assert_array_equal(o, wo)


@pytest.mark.parametrize("n", [2, 8])
def test_smap_screen_sharded_equals_jax(n):
    """Gn2Eval over SMAP templates, a same-shape bucket of 3 split over
    2 and 8 entries (empty shards included) beside a bucket of 1."""
    from alignment_algos_tpu.scoring.gn2_eval import Gn2Eval, Gn2Params
    from alignment_algos_tpu.structure.smap import SMAPSequence
    from alignment_algos_tpu_torch.scoring.gn2_eval import (
        Gn2Eval as TGn2Eval, Gn2Params as TGn2Params)
    from alignment_algos_tpu_torch.structure.smap import (
        SMAPSequence as TSMAPSequence)
    (jq,), (q,) = _hmap_pair(("query30.prof",), DATA)
    files = ["templ_smap.prof"] * 3 + ["templ_big.prof"]
    jts = [SMAPSequence.from_file(os.path.join(DATA, f), gn2=True)
           for f in files]
    ts = [TSMAPSequence.from_file(os.path.join(DATA, f), gn2=True)
          for f in files]
    jp, tp = Gn2Params(), TGn2Params()
    js, jo = jscreen.screen_profiles(jq, jts, lambda a, b: Gn2Eval(jp), k=4,
                                     mesh=jscreen.default_mesh(n))
    s, o = screen.screen_profiles(q, ts, lambda a, b: TGn2Eval(tp), k=4,
                                  device=CPU,
                                  mesh=screen.default_mesh(n, device=CPU))
    os_, oo = screen.screen_profiles(q, ts, lambda a, b: TGn2Eval(tp), k=4,
                                     device=CPU)
    for ws, wo in ((js, jo), (os_, oo)):
        np.testing.assert_array_equal(_bits(s), _bits(ws))
        np.testing.assert_array_equal(o, wo)


# ----------------------------------------------- C6: past K3's caps, on K7

@pytest.fixture
def capped(monkeypatch):
    """Both K3 caps patched to t2 = 30; records the (pairs, q2, t2) of
    every bucket K7 and K3 score on the host-build route."""
    from alignment_algos_tpu_torch.ops import dp_engine, dp_scores
    monkeypatch.setattr(dp_scores, "vec_max_t2", lambda device: 30)
    monkeypatch.setattr(dp_scores, "table_max_t2", lambda device: 30)
    seen = {"k7": [], "k3": []}
    for key, mod, name in (("k7", dp_engine, "build_forward_batched"),
                           ("k3", dp_scores, "forward_scores_batch")):
        def spy(costs, *a, _real=getattr(mod, name), _key=key, **kw):
            seen[_key].append((len(costs), costs[0].q_size,
                               costs[0].t_size))
            return _real(costs, *a, **kw)
        monkeypatch.setattr(mod, name, spy)
    return seen


@pytest.mark.parametrize("n", [None, 2])
def test_c6_subclass_evaluator_past_cap_takes_k7(capped, n):
    """An HMAPaliEval subclass (the host-build route) on a library with
    t2 on both sides of the patched cap: K3 scores the short buckets, K7
    the long ones, on one device and over a mesh; every score bit-equal
    to the JAX screen_profiles."""
    from alignment_algos_tpu.scoring.hmap_eval import HMAPaliEval
    from alignment_algos_tpu.seq.hmap import HMAPSequence
    from alignment_algos_tpu.utils.params import HMAPaliParams
    from alignment_algos_tpu_torch.scoring.hmap_eval import (
        HMAPaliEval as THMAPaliEval)
    from alignment_algos_tpu_torch.seq.hmap import (
        HMAPSequence as THMAPSequence)
    from alignment_algos_tpu_torch.utils.params import (
        HMAPaliParams as THMAPaliParams)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_profiles import make_profile

    class Sub(THMAPaliEval):
        pass

    class JSub(HMAPaliEval):
        pass

    rng = np.random.default_rng(21)
    texts = [make_profile(rng, f"c{i}", m)
             for i, m in enumerate((22, 20, 28, 34, 20, 34, 31))]
    jq, *jts = [HMAPSequence.from_stream(io.StringIO(t)) for t in texts]
    q, *ts = [THMAPSequence.from_stream(io.StringIO(t)) for t in texts]
    tp, jp = THMAPaliParams(), HMAPaliParams()
    mesh = None if n is None else screen.default_mesh(n, device=CPU)
    s, o = screen.screen_profiles(q, ts, lambda a, b: Sub(tp), k=6,
                                  device=CPU, mesh=mesh)
    if n is None:
        want_k3, want_k7 = [(2, 24, 22), (1, 24, 30)], [(2, 24, 36),
                                                        (1, 24, 33)]
    else:       # the two-pair buckets split over the two entries
        want_k3 = [(1, 24, 22), (1, 24, 22), (1, 24, 30)]
        want_k7 = [(1, 24, 36), (1, 24, 36), (1, 24, 33)]
    assert sorted(capped["k3"]) == sorted(want_k3)
    assert sorted(capped["k7"]) == sorted(want_k7)
    js, jo = jscreen.screen_profiles(jq, jts, lambda a, b: JSub(jp), k=6)
    np.testing.assert_array_equal(_bits(s), _bits(js))
    np.testing.assert_array_equal(o, jo)


def test_c6_gn2_smap_past_cap_takes_k7(capped):
    """Gn2Eval (K3's table form) on the SMAP fixtures, both past the
    patched cap: K7 scores both buckets, bit-equal to the JAX
    screen_profiles."""
    from alignment_algos_tpu.scoring.gn2_eval import Gn2Eval, Gn2Params
    from alignment_algos_tpu.structure.smap import SMAPSequence
    from alignment_algos_tpu_torch.ops import dp_scores
    from alignment_algos_tpu_torch.scoring.gn2_eval import (
        Gn2Eval as TGn2Eval, Gn2Params as TGn2Params)
    from alignment_algos_tpu_torch.structure.smap import (
        SMAPSequence as TSMAPSequence)
    (jq,), (q,) = _hmap_pair(("query30.prof",), DATA)
    files = ["templ_smap.prof", "templ_big.prof"]
    jts = [SMAPSequence.from_file(os.path.join(DATA, f), gn2=True)
           for f in files]
    ts = [TSMAPSequence.from_file(os.path.join(DATA, f), gn2=True)
          for f in files]
    tp = TGn2Params()
    ev = TGn2Eval(tp)
    assert not dp_scores.vector_form([ev.build_costs(q, ts[0])])
    s, o = screen.screen_profiles(q, ts, lambda a, b: TGn2Eval(tp), k=2,
                                  device=CPU)
    assert capped["k3"] == [] and sorted(capped["k7"]) == [(1, 28, 32),
                                                           (1, 28, 53)]
    jp = Gn2Params()
    js, jo = jscreen.screen_profiles(jq, jts, lambda a, b: Gn2Eval(jp), k=2)
    np.testing.assert_array_equal(_bits(s), _bits(js))
    np.testing.assert_array_equal(o, jo)
