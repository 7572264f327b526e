"""The port's DTW alignment (``ste_gan_torch/ops/dtw.py``) on the CPU, where
``dtw_alignment_batched`` runs its plain PyTorch version: alignments
identical to the numpy oracle and to the JAX ``dtw_alignment`` (with and
without ``end=``, and batched over padded slots, empty ones included), the
f32 DP within 1e-6 of JAX's (both take the same exact f32 min and add), and
monotone paths. The CUDA kernel is held to this plain version on the card
by ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ste_gan_torch.ops import dtw as tdtw
from ste_gan_tpu.ops import dtw as jdtw

SHAPES = [(1, 6), (6, 1), (2, 2), (9, 7), (25, 40), (45, 60), (60, 45)]


def _align(costs, end=None):
    t1, t2 = costs.shape
    end = (t1 - 1, t2 - 1) if end is None else end
    return tdtw.dtw_alignment_batched(
        torch.from_numpy(costs)[None],
        torch.tensor([end], dtype=torch.int32))[0].numpy()


@pytest.mark.parametrize("shape", SHAPES)
def test_alignment_identical_to_numpy_and_jax(shape):
    costs = np.random.default_rng(sum(shape)).random(shape).astype(np.float32)
    got = _align(costs)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, tdtw.dtw_alignment_np(costs))
    np.testing.assert_array_equal(got, np.asarray(jdtw.dtw_alignment(
        jnp.asarray(costs))))


@pytest.mark.parametrize("shape", [(12, 12), (20, 33), (33, 20)])
def test_ties_break_as_the_reference_does(shape):
    """Integer costs tie often: the first minimum in the order up, left,
    diag decides, as in the numpy oracle and JAX's argmin."""
    costs = np.random.default_rng(sum(shape)).integers(
        0, 3, shape).astype(np.float32)
    got = _align(costs)
    np.testing.assert_array_equal(got, tdtw.dtw_alignment_np(costs))
    np.testing.assert_array_equal(got, np.asarray(jdtw.dtw_alignment(
        jnp.asarray(costs))))


@pytest.mark.parametrize("shape", SHAPES)
def test_dp_matches_jax(shape):
    costs = np.random.default_rng(7 + sum(shape)).normal(
        size=shape).astype(np.float32) ** 2
    got = tdtw.dtw_matrix_plain(torch.from_numpy(costs)[None])[0].numpy()
    want = np.asarray(jdtw.dtw_matrix(jnp.asarray(costs)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, tdtw.dtw_matrix_np(costs), rtol=1e-5)


@pytest.mark.parametrize("end", [(29, 24), (10, 5), (0, 7), (5, 0), (1, 1)])
def test_end_cell_matches_jax(end):
    costs = np.random.default_rng(3).random((30, 25)).astype(np.float32)
    want = np.asarray(jdtw.dtw_alignment(jnp.asarray(costs), end=end))
    np.testing.assert_array_equal(_align(costs, end), want)
    # The valid block alone aligns the same way.
    block = costs[:end[0] + 1, :end[1] + 1]
    if min(block.shape) > 0:
        np.testing.assert_array_equal(_align(costs, end)[:end[0] + 1],
                                      tdtw.dtw_alignment_np(block))


def test_batched_slots_with_empty_ones():
    rng = np.random.default_rng(11)
    costs = rng.random((6, 40, 35)).astype(np.float32)
    ends = np.array([[39, 34], [20, 30], [-1, -1], [0, 12], [33, 9],
                     [-1, 4]], np.int32)
    got = tdtw.dtw_alignment_batched(torch.from_numpy(costs),
                                     torch.from_numpy(ends)).numpy()
    for s, (ei, ej) in enumerate(ends):
        want = np.asarray(jdtw.dtw_alignment(jnp.asarray(costs[s]),
                                             end=(ei, ej)))
        np.testing.assert_array_equal(got[s], want, err_msg=f"slot {s}")
    assert not got[2].any() and not got[5].any()


@pytest.mark.parametrize("shape", [(50, 50), (30, 70), (70, 30)])
def test_alignment_is_monotone(shape):
    costs = np.random.default_rng(5).random(shape).astype(np.float32)
    got = _align(costs)
    # Row 0 is never written (the walk stops there); every other row holds
    # the first column of the path in it, non-decreasing with the row.
    assert got[0] == 0
    assert np.all(np.diff(got[1:]) >= 0)
    assert np.all((got[1:] >= 1) & (got[1:] < shape[1]))


def test_wrapper_checks_its_inputs():
    costs = torch.zeros((2, 4, 5))
    with pytest.raises(ValueError, match="want"):
        tdtw.dtw_alignment_batched(costs, torch.zeros((3, 2), dtype=torch.int32))
    with pytest.raises(TypeError, match="int32"):
        tdtw.dtw_alignment_batched(costs, torch.zeros((2, 2)))
    with pytest.raises(TypeError, match="float32"):
        tdtw.dtw_alignment_batched(costs.double(),
                                   torch.zeros((2, 2), dtype=torch.int32))


# ---------------------------------------------------------------------------
# The kernel's formulation: direction codes and their walk
# ---------------------------------------------------------------------------


def _codes_walk(costs, ends):
    codes = tdtw.dtw_directions_plain(torch.from_numpy(costs))
    return tdtw.dtw_backtrace_codes_plain(codes, torch.from_numpy(ends))


@pytest.mark.parametrize("kind", ["random", "ties", "edge_ends"])
def test_direction_codes_walk_identical_to_plain_and_jax(kind):
    """The kernel's 2-bit codes (the backtrace's comparisons in its order,
    taken on the values that enter the cell's min) and the walk that reads
    one code a step give the plain version's and JAX's alignments, ties and
    short, empty and one-row or one-column ends included."""
    rng = np.random.default_rng({"random": 1, "ties": 2, "edge_ends": 3}[kind])
    shape = (6, 37, 29)
    costs = (rng.integers(0, 3, shape) if kind == "ties"
             else rng.random(shape)).astype(np.float32)
    ends = np.stack([rng.integers(10, 37, 6), rng.integers(10, 29, 6)],
                    1).astype(np.int32)
    if kind == "edge_ends":
        ends[:] = [[36, 28], [-1, -1], [0, 20], [25, 0], [1, 1], [36, 3]]
    got, steps = _codes_walk(costs, ends)
    want = tdtw.dtw_alignment_plain(torch.from_numpy(costs),
                                    torch.from_numpy(ends))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    for s, (ei, ej) in enumerate(ends):
        jax_ends = (int(ei), int(ej))
        np.testing.assert_array_equal(
            got[s].numpy(), np.asarray(jdtw.dtw_alignment(
                jnp.asarray(costs[s]), end=jax_ends)), err_msg=f"slot {s}")
        # Each step lowers i, j or both by one until one of them is 0; none
        # from an empty or border end.
        if ei <= 0 or ej <= 0:
            assert steps[s] == 0
        else:
            assert min(ei, ej) <= steps[s] <= ei + ej


def test_direction_codes_are_the_first_minimal_predecessor():
    costs = np.random.default_rng(4).integers(0, 2, (1, 12, 10)).astype(
        np.float32)
    codes = tdtw.dtw_directions_plain(torch.from_numpy(costs))[0].numpy()
    dtw = tdtw.dtw_matrix_np(costs[0])
    for i in range(1, 12):
        for j in range(1, 10):
            cand = [dtw[i - 1, j], dtw[i, j - 1], dtw[i - 1, j - 1]]
            assert codes[i, j] == int(np.argmin(cand)), (i, j)
    assert not codes[0].any() and not codes[:, 0].any()


@pytest.mark.parametrize("t1,t2,shared,threads", [
    (259, 259, True, 288),      # the mixed corpus's slots
    (500, 600, True, 512),      # a long utterance
    (1000, 1000, False, 1024),  # codes past shared memory
    (2100, 300, False, 1024),   # rows in strips of 1,024
    (4500, 64, True, 1024),     # five strips, narrow codes
    (1, 300, True, 32), (300, 1, True, 320), (400, 150, True, 416)])
def test_dtw_plan(t1, t2, shared, threads):
    """Shared or global direction codes, one thread a row up to 1,024 (then
    strips), and never more than a block's 232,448 bytes of shared
    memory."""
    plan = tdtw.plan_dtw(t1, t2)
    assert plan.shared_codes is shared and plan.threads == threads
    assert plan.words_per_row * 16 >= t2 > (plan.words_per_row - 1) * 16
    assert plan.smem_bytes <= 232_448
    codes_bytes = 4 * t1 * plan.words_per_row
    if shared:
        assert plan.smem_bytes >= codes_bytes
    else:
        assert plan.smem_bytes + codes_bytes > 232_448


def test_dtw_plan_refuses_a_boundary_row_past_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        tdtw.plan_dtw(5000, 60_000)
