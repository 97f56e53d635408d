"""The frozen yardstick against the program's own arithmetic at today's
tree, on the cells' shapes, and the generators' distributions."""
import cardbench_fixtures  # noqa: F401  (puts the checkout on the path)
import pytest
import torch

from cardbench.yardstick import bounds, glm_data, peaks, streams


def test_peaks_equal_the_programs():
    from repro_torch.launch import mesh
    assert (peaks.PEAK_OPS_F32, peaks.HBM_BW) == (
        mesh.PEAK_OPS_F32, mesh.HBM_BW)


@pytest.mark.parametrize("H", [4096, 1024])
def test_kernel_bounds_equal_the_programs(H):
    from repro_torch.bench import bounds as prog
    g = torch.Generator().manual_seed(H)
    idx = torch.randint(0, 4096, (8, H), generator=g, dtype=torch.int32)
    assert bounds.kernel_bounds(idx, 4103, 16384, 2048) == \
        prog.kernel_bounds(idx, 4103, 16384, 2048)


@pytest.mark.parametrize("L", [1, 4096, 16384, 253_755_392, 266_338_304])
@pytest.mark.parametrize("K", [1, 4, 8])
def test_codec_bounds_equal_the_programs(K, L):
    from repro_torch.bench import bounds as prog
    assert bounds.codec_bounds(K, L, max(1, L // 8)) == \
        prog.codec_bounds(K, L, max(1, L // 8))


def test_glm_data_distribution():
    A, b = glm_data.make_glm_data(512, 1024, density=0.15, zipf_a=1.1,
                                  noise=0.1, truth_density=0.05, seed=5,
                                  device="cpu")
    A2, b2 = glm_data.make_glm_data(512, 1024, density=0.15, zipf_a=1.1,
                                    noise=0.1, truth_density=0.05, seed=5,
                                    device="cpu")
    assert torch.equal(A, A2) and torch.equal(b, b2)
    assert abs(float((A != 0).float().mean()) - 0.15) < 0.01
    # the column scales are the Zipf ranks' in some order
    top = A.abs().amax(0).sort(descending=True).values
    assert top[0] > 5 * top[100]


@pytest.mark.parametrize("H", [4096, 1024])
def test_kernel_bounds_equal_the_programs_at_the_cells_shape(H):
    from repro_torch.bench import bounds as prog
    g = torch.Generator().manual_seed(H)
    idx = torch.randint(0, 1536, (8, H), generator=g, dtype=torch.int32)
    assert bounds.kernel_bounds(idx, 1536, 350_000, 1) == \
        prog.kernel_bounds(idx, 1536, 350_000, 1)


@pytest.mark.parametrize("seed", [0, 2**31 + 11, 3_800_000_017])
def test_frozen_draw_equals_the_programs(seed):
    from repro_torch.core.cocoa import UniformIndices
    sizes = [1536, 1535, 1537, 1536]
    s = streams.solve_seed(seed, 4)
    mine = streams.UniformDraw(sizes, 1024, s, "cpu")
    prog = UniformIndices(sizes, 1024, s, torch.device("cpu"))
    for t in (1, 2, 177):
        assert torch.equal(mine(t), prog(t))


def test_solve_seeds_fit_the_programs_generator():
    for seed in (0, 2**31 + 5, 2**62, -7):
        for i in (0, 1, 9999):
            s = streams.solve_seed(seed, i)
            assert 0 <= s < 2**streams.SOLVE_SEED_BITS
            assert s * 1_000_003 + 10**6 < 2**64
    assert len({streams.solve_seed(5, i) for i in range(1000)}) == 1000


def test_streams_reproducible_and_uniform():
    a = streams.UniformDraw([100, 90], 4096, streams.solve_seed(2**31, 3),
                            "cpu")
    b = streams.UniformDraw([100, 90], 4096, streams.solve_seed(2**31, 3),
                            "cpu")
    assert torch.equal(a(5), b(5)) and not torch.equal(a(5), a(6))
    x = a(1)
    assert int(x[0].max()) == 99 and int(x[1].max()) == 89
    assert int(x.min()) == 0
    assert streams.mix(2**40, -1) < 2**63
