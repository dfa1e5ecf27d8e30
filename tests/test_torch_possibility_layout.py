"""The possibility kernels' launch layout, scratch and build, all of which
run without a card: every (c, d) covered once, the tile and split chosen
at the main paths' sizes, the partials' scratch, the merged source's
library name and hash, and the per-size launch counts.  The kernels
themselves are held against their plain twins on the card by
``tests/test_torch_gpu.py``."""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels.possibility import kernel as K


def _owners(lay, n, c):
    """How many threads of the launch own each (c, d), following the
    index arithmetic of ``csrc/possibility.cu``: a tile block → (its
    destination tile, its channel tile), lane → (lane / 8, lane % 8),
    warp → (warp / 2, warp % 2) along (channels, destinations)."""
    tc, td = K.THREAD_TILES[lay.cfg]
    gx, gy = lay.grid
    tid = np.arange(K.BLOCK_THREADS)
    lane, warp = tid % 32, tid // 32
    dl = ((warp % K.WARPS[1]) * K.LANES[1] + lane % K.LANES[1]) * td
    cl = ((warp // K.WARPS[1]) * K.LANES[0] + lane // K.LANES[1]) * tc
    bx, by, t, i, j = np.meshgrid(np.arange(gx), np.arange(gy), tid,
                                  np.arange(tc), np.arange(td),
                                  indexing="ij")
    ch = by * lay.tile[0] + cl[t] + i
    d = bx * lay.tile[1] + dl[t] + j
    keep = (ch < c) & (d < n)
    return np.bincount((ch * n + d)[keep], minlength=c * n).reshape(c, n)


@pytest.mark.parametrize("cfg", range(len(K.THREAD_TILES)))
@pytest.mark.parametrize("n,c", [(1, 1), (16, 16), (25, 80), (33, 17),
                                 (90, 360), (256, 1024)])
def test_layout_covers_every_output_once(n, c, cfg):
    lay = K._layout(n, c, cfg)
    assert lay.tile == (K.WARPS[0] * K.LANES[0] * K.THREAD_TILES[cfg][0],
                        K.WARPS[1] * K.LANES[1] * K.THREAD_TILES[cfg][1])
    # the grid is the least that covers (N, C): one tile fewer would not
    assert (lay.grid[0] - 1) * lay.tile[1] < n <= lay.grid[0] * lay.tile[1]
    assert (lay.grid[1] - 1) * lay.tile[0] < c <= lay.grid[1] * lay.tile[0]
    assert np.array_equal(_owners(lay, n, c), np.ones((c, n), np.int64))


@pytest.mark.parametrize("n,c,weights,cfg,splits", [
    (16, 16, False, 2, 1),        # 4x4 golden, ctrl: one launch
    (25, 25, False, 2, 1),        # the paper's 5x5
    (25, 80, True, 2, 1),         # Fig. 1's mesh2d(5, 5): one launch
    (256, 256, False, 2, 8),      # torus(16, 16), build_plan_fast
    (256, 1024, True, 1, 8),      # torus(16, 16), build_plan
    (1024, 1024, False, 0, 16),   # mesh2d(32, 32)
    (1024, 3968, True, 0, 16),
])
def test_layout_choice_at_the_main_path_sizes(n, c, weights, cfg, splits):
    """The tile each main-path size gets on an H100 (132 SMs), as timed
    on the card; W at 4x4–5x5 stays one launch (no partials)."""
    lay = K.possibility_layout(n, c, weights, sms=132)
    assert (lay.cfg, lay.splits) == (cfg, splits)


def test_layout_rejects_an_empty_pass():
    with pytest.raises(ValueError):
        K.possibility_layout(0, 4, weights=False)
    with pytest.raises(ValueError):
        K.possibility_layout(4, 0, weights=True)


@pytest.mark.parametrize("n,c", [(25, 80), (256, 1024), (1024, 3968)])
def test_weights_scratch_is_one_row_a_destination_tile(n, c):
    lay = K.possibility_layout(n, c, weights=True)
    part_w = K.weights_scratch(lay, c, "cpu")
    if lay.splits == 1:
        assert part_w is None
    else:
        assert part_w.shape == (lay.splits, c)
        assert part_w.dtype == torch.float64


def test_library_path_hashes_the_merged_source(tmp_path, monkeypatch):
    """Both passes build from one source into one library, named by a
    hash of that source: an edit gives a new name."""
    assert build.SOURCES["possibility"] == "possibility.cu"
    assert [k for k in build.SOURCES if k.startswith("possibility")] == [
        "possibility"]
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "out"))
    src = tmp_path / "csrc"
    src.mkdir()
    text = (build.CSRC / "possibility.cu").read_text()
    (src / "possibility.cu").write_text(text)
    monkeypatch.setattr(build, "CSRC", src)
    first = build.library_path("possibility")
    assert first.parent == tmp_path / "out"
    assert first.name.startswith("libpossibility-")
    assert build.library_path("possibility") == first
    (src / "possibility.cu").write_text(text + "\n// edited\n")
    assert build.library_path("possibility") != first


def test_ptxas_report_names_the_function_of_a_spill_line(tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    log = build.library_path("possibility").with_suffix(".log")
    log.write_text(
        "ptxas info    : Function properties for kern_a\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
        "loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers\n"
        "ptxas info    : Function properties for kern_b\n"
        "    8 bytes stack frame, 8 bytes spill stores, 12 bytes spill "
        "loads\n")
    lines = build.ptxas_report("possibility").splitlines()
    assert "Used 168 registers" in lines[2]
    assert lines[1].endswith("kern_a: 0 bytes stack frame, 0 bytes spill "
                             "stores, 0 bytes spill loads")
    assert "kern_b: 8 bytes stack frame" in lines[4]


def test_reset_launches_clears_the_counts_by_size():
    before = dict(kernels.LAUNCHES)
    kernels.LAUNCH_SIZES[("possibility_v", 16, 16)] += 1
    kernels.reset_launches()
    assert not kernels.LAUNCH_SIZES
    assert set(kernels.LAUNCHES) == set(before)
    assert all(v == 0 for v in kernels.LAUNCHES.values())


def test_cpu_path_counts_no_launch_by_size():
    d = torch.zeros((4, 4), dtype=torch.int32)
    kernels.reset_launches()
    from repro_torch.kernels.possibility import possibility_v
    possibility_v(d, d, torch.zeros((4, 4), dtype=torch.float64), d)
    assert not kernels.LAUNCH_SIZES
