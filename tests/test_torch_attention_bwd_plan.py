"""The split plan of K8's float32 ("fma") dK/dV kernel, on the CPU.

The kernel (``csrc/flash_attention.cu:flash_attention_bwd_dkdv_kernel``)
gives each (batch, KV head, 64-key tile) to a thread-block cluster of R
blocks; the tile's items, (query head gi, 32-query tile) pairs whose rows
keep one of its keys, in the order ``gi * n_qt + j``, are cut into R
contiguous shares, and the partial sums are added in rank order.  The plan
is a pure function of the shape (``flash_attention.fma_dkdv_plan``), held
here against the forward's mask by brute force; ``tests/test_torch_cuda.py``
holds it against the C launcher's on the card.  No JAX.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as k8  # noqa: E402

# (b, s, t, h, kv, d, causal, window): train_lm's attention, the forward's
# main shape, D = 112, non-causal S != T (both ways), a window at G = 48
# with a ragged S, MQA G = 48, cross attention, G = 1, one key tile, a
# single item, a window past S, ragged S and T
SHAPES = [
    (4, 192, 192, 12, 4, 64, True, 0),
    (1, 2048, 2048, 32, 8, 128, True, 0),
    (2, 515, 515, 8, 2, 112, True, 0),
    (2, 515, 300, 8, 2, 32, False, 0),
    (1, 300, 1000, 32, 8, 128, False, 0),
    (1, 515, 515, 48, 1, 64, True, 100),
    (1, 1000, 1000, 48, 1, 128, True, 0),
    (2, 64, 1500, 8, 8, 64, False, 0),
    (1, 200, 200, 1, 1, 32, True, 0),
    (1, 40, 40, 4, 4, 16, True, 0),
    (1, 20, 20, 1, 1, 16, True, 0),
    (1, 100, 100, 4, 1, 16, True, 24),
    (1, 130, 130, 8, 2, 64, True, 500),
    (3, 77, 33, 6, 3, 32, False, 0),
    (1, 1000, 1000, 32, 8, 128, True, 512),
    (2, 131, 131, 4, 4, 112, True, 0),
]


def _ids(shape):
    b, s, t, h, kv, d, causal, window = shape
    return f"b{b}_s{s}_t{t}_g{h // kv}_kv{kv}_d{d}_{'causal' if causal else 'full'}_w{window}"


def _reaching(shape, kt):
    """The (head gi, query tile) items whose rows keep a key of key tile kt,
    by brute force over the forward's mask, in the kernel's order."""
    b, s, t, h, kv, d, causal, window = shape
    qpos = np.arange(s)[:, None]
    kpos = np.arange(kt * k8.FMA_BWD_KEYS, min((kt + 1) * k8.FMA_BWD_KEYS, t))[None, :]
    keep = np.ones((s, kpos.shape[1]), bool)
    if causal:
        keep &= kpos <= qpos
    if window:
        keep &= kpos > qpos - window
    rows = np.flatnonzero(keep.any(axis=1))
    tiles = sorted(set((rows // k8.FMA_BWD_QUERIES).tolist()))
    return [(gi, qt) for gi in range(h // kv) for qt in tiles]


def _wave(d):
    return build.ONE_WAVE_BLOCKS // 2 if d >= 112 else build.ONE_WAVE_BLOCKS


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_every_reaching_item_belongs_to_one_rank_in_order(shape):
    """Walking rank 0's share, then rank 1's, and so on, visits exactly the
    (head, query tile) items whose rows keep a key of the tile, each once,
    in the kernel's order gi * n_qt + j."""
    plan = k8.fma_dkdv_plan(*shape)
    assert len(plan["tiles"]) == -(-shape[2] // k8.FMA_BWD_KEYS)
    for kt, (qt0, n_qt, bounds) in enumerate(plan["tiles"]):
        assert len(bounds) == plan["ranks"] + 1 and bounds[0] == 0
        walked = [(i // n_qt, qt0 + i % n_qt)
                  for r in range(plan["ranks"]) for i in range(bounds[r], bounds[r + 1])]
        assert walked == _reaching(shape, kt), kt


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_shares_are_contiguous_and_within_one_item(shape):
    """The ranks' shares of each key tile are contiguous, in rank order, and
    differ in size by at most one item."""
    plan = k8.fma_dkdv_plan(*shape)
    for qt0, n_qt, bounds in plan["tiles"]:
        sizes = np.diff(bounds)
        assert bounds[-1] == shape[3] // shape[4] * n_qt
        assert (sizes >= 0).all() and sizes.max() - sizes.min() <= 1


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_grid_fits_one_wave_and_ranks_are_the_largest_that_do(shape):
    """R is a power of two up to FMA_BWD_MAX_RANKS whose grid (batch * kv *
    key tiles * R blocks) fits one wave (half of ONE_WAVE_BLOCKS at D >=
    112) with an item for every rank of the busiest key tile; 2 R would
    break one of those; R = 1 where the busiest key tile has one item."""
    b, s, t, h, kv, d, causal, window = shape
    plan = k8.fma_dkdv_plan(*shape)
    ranks = plan["ranks"]
    tiles = b * kv * len(plan["tiles"])
    most = max(h // kv * n_qt for _, n_qt, _ in plan["tiles"])
    assert ranks >= 1 and ranks & (ranks - 1) == 0 and ranks <= k8.FMA_BWD_MAX_RANKS
    assert ranks == 1 or (tiles * ranks <= _wave(d) and ranks <= most)
    assert (2 * ranks > k8.FMA_BWD_MAX_RANKS or tiles * 2 * ranks > _wave(d)
            or 2 * ranks > most)
    if most <= 1:
        assert ranks == 1
    assert ranks == k8.fma_dkdv_ranks(*shape)


def test_train_lm_plan():
    """train_lm's attention (B = 4, S = T = 192, 12 heads over 4, D = 64,
    causal): 48 key tiles of 18, 12 and 6 items split over clusters of 4,
    192 blocks, so the longest walk is 5 items of 32 queries where the
    block of the parent design walked 9 of 64."""
    plan = k8.fma_dkdv_plan(4, 192, 192, 12, 4, 64, True, 0)
    assert plan["ranks"] == 4
    assert [(qt0, n_qt) for qt0, n_qt, _ in plan["tiles"]] == [(0, 6), (2, 4), (4, 2)]
    assert [b for _, _, b in plan["tiles"]] == [[0, 4, 9, 13, 18], [0, 3, 6, 9, 12],
                                                [0, 1, 3, 4, 6]]


@pytest.mark.parametrize("tiles,max_split,max_by_work,wave,ranks", [
    (48, 8, 18, 240, 4),
    (48, 8, 18, 120, 2),
    (256, 8, 256, 120, 1),
    (10, 8, 100, 120, 8),
    (10, 8, 3, 240, 2),
])
def test_split_ranks_with_a_wave(tiles, max_split, max_by_work, wave, ranks):
    """build.split_ranks with the wave given: the largest power of two up to
    max_split and max_by_work whose grid fits ``wave`` blocks, at least 1."""
    assert build.split_ranks(tiles, max_split, max_by_work, wave=wave) == ranks
