"""Port parity: ``repro_torch.core.graph`` is a numpy copy of the
reference's graph module, so every generator must give EXACTLY the
reference's edges, colorings and edge schedules for the same seeds."""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import graph as jg  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402

CASES = [
    ("ring", (2,)), ("ring", (8,)), ("chain", (6,)), ("star", (5,)),
    ("complete", (5,)), ("paper_fig2a", ()), ("hypercube", (3,)),
    ("expander", (10, 3, 0)), ("expander", (12, 4, 5)),
    ("erdos", (9, 0.3, 1)), ("erdos", (7, 0.0, 0)),
]


@pytest.mark.parametrize("name,args", CASES)
def test_generators_match_reference_exactly(name, args):
    a, b = getattr(tg, name)(*args), getattr(jg, name)(*args)
    assert a.m == b.m and a.edges == b.edges
    np.testing.assert_array_equal(a.adjacency(), b.adjacency())
    np.testing.assert_array_equal(a.degrees(), b.degrees())
    np.testing.assert_array_equal(a.incidence(), b.incidence())
    np.testing.assert_array_equal(a.coloring(), b.coloring())
    assert a.chromatic_schedule() == b.chromatic_schedule()
    np.testing.assert_array_equal(a.edge_coloring(), b.edge_coloring())
    assert a.edge_schedule() == b.edge_schedule()
    assert tg.spectral_gap(a) == jg.spectral_gap(b)


@pytest.mark.parametrize("name,args", CASES)
def test_compiled_edge_schedules_match_reference(name, args):
    a = tg.compile_edge_schedule(getattr(tg, name)(*args))
    b = jg.compile_edge_schedule(getattr(jg, name)(*args))
    assert a.rounds == b.rounds
    assert a.bidir_perms == b.bidir_perms and a.dir_perms == b.dir_perms
    np.testing.assert_array_equal(a.slot, b.slot)
    np.testing.assert_array_equal(a.own, b.own)
    assert (a.n_slots, a.n_edges, a.n_rounds) == (b.n_slots, b.n_edges,
                                                  b.n_rounds)


def test_expander_min_gap_and_errors_match_reference():
    a = tg.expander(16, 3, seed=2, min_gap=0.02)
    b = jg.expander(16, 3, seed=2, min_gap=0.02)
    assert a.edges == b.edges
    for mod in (tg, jg):
        with pytest.raises(ValueError, match="connected"):
            mod.Graph(m=3, edges=((0, 1),))
        with pytest.raises(ValueError, match="edgeless"):
            mod.compile_edge_schedule(mod.Graph(m=1, edges=()))
        with pytest.raises(ValueError, match="parallel edge"):
            mod.Graph(m=2, edges=((0, 1), (1, 0))).edge_coloring()
