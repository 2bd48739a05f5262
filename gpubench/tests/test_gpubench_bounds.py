"""The benchmark's copy of the bound arithmetic reproduces the bounds the
kernel table of PERF.md states."""
from gpubench.lib import bounds


def test_b1_main_path_cell():
    # Kb=8192, L=8, Kr=3, Sb=Sr=3, D=2, tau=10, float32
    b = bounds.b1_bound(8192, 8 * 3, 3, 3, 2, 10, 4)
    assert round(b["bound_ms"], 4) == 0.0082
    assert b["bound_by"] == "operations"


def test_b2_fused_full_width():
    # 8192 subjects x 20 restarts, 25 sequences of T=50, K=2, D=2
    lanes = (8192, 20)
    b = bounds.b2_fused_bound(lanes, 25, 50, 2, 2, 4, 8192 * 20 * 25 * 50)
    assert round(b["bound_ms"], 4) == 1.0314
    assert b["bound_by"] == "bytes"


def test_b1_grid_chunk_each_lane_at_its_own_s():
    # the padded grid's 960-lane chunk: K=1..6 x S=1..5, 64 restarts
    cells = [(k, s) for k in range(1, 7) for s in range(1, 6)
             for _ in range(64)]
    b = bounds.b1_bound_live(8192, cells[:960], 6, 2, 5, 2, 50, 4)
    assert round(b["bound_ms"], 4) == 6.7251
