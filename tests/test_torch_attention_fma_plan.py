"""K8's float32 ("fma") forward plan and the backward's Delta order, on the
CPU (no JAX, no card).

``flash_attention.fma_forward_plan`` is the launch the C launcher makes
(``csrc/flash_attention.cu:ff_plan``; ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold the two equal on the card): every row of the
(q position, group member) index in exactly one block, row tiles issued
latest first, each block's key tiles exactly the mask's reach, and at
train_lm's shape one wave.  ``delta_in_kernel_order`` is Delta's kernel
sum order in plain PyTorch: held here against the plain Delta and against
a lane-by-lane loop in numpy.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa

BF16, F32 = torch.bfloat16, torch.float32

# (b, s, t, h, kv, d, causal, window): chip_smoke.py's cases on the fma
# route (K8_CASES' float32 cases and the main shape in float32) and the
# float32 SMOKE configs' shapes, plus edges: S != T, a window at G = 48,
# G = 1 at D = 112, a row tile larger than S * G
TRAIN_LM = (4, 192, 192, 12, 4, 64, True, 0)
FMA_CASES = [
    (1, 2048, 2048, 32, 8, 128, True, 0),        # main_f32
    (1, 1024, 1024, 32, 8, 128, True, 0),        # f32_d128
    (2, 515, 515, 8, 2, 16, True, 0),            # f32_d16
    (2, 515, 515, 8, 2, 32, True, 0),            # f32_d32
    (2, 515, 515, 8, 2, 64, True, 0),            # f32_d64
    (2, 515, 515, 8, 2, 112, True, 0),           # f32_d112
    TRAIN_LM,                                    # train_f32_d64
    (2, 32, 32, 4, 2, 16, True, 0),              # a SMOKE config's prefill
    (1, 515, 515, 48, 1, 64, True, 100),         # a window at G = 48
    (2, 515, 300, 8, 2, 32, False, 0),           # non-causal, S != T
    (1, 77, 200, 8, 8, 112, False, 0),           # D = 112, G = 1, S != T
    (1, 700, 700, 12, 2, 128, True, 256),        # Mixtral's G = 6 with a window
    (2, 40, 1500, 8, 8, 64, False, 0),           # Whisper's cross attention
    (1, 3, 3, 2, 1, 64, True, 0),                # one row tile past S * G
]


def _block_rows(plan: dict, n_bkv: int, block: int) -> tuple[int, int, int]:
    """``(bkv, r0, r1)`` of block ``block`` as the kernel reads its index:
    row tile ``row_tiles - 1 - block // n_bkv`` (the plan's tiles are in
    that issue order), batch * KV head ``block % n_bkv``."""
    r0, r1, _, _ = plan["tiles"][block // n_bkv]
    return block % n_bkv, r0, r1


def _reach(r0, r1, g, t, causal, window) -> set[int]:
    """The key tiles holding a key that some row of [r0, r1) keeps, by
    brute force over the rows' q positions and every key."""
    qpos = np.unique(np.arange(r0, r1) // g)[:, None]
    kpos = np.arange(t)[None, :]
    keep = np.ones((qpos.shape[0], t), dtype=bool)
    if causal:
        keep &= kpos <= qpos
    if window:
        keep &= kpos > qpos - window
    return set((np.nonzero(keep.any(axis=0))[0] // fa.KV_TILE).tolist())


@pytest.mark.parametrize("case", FMA_CASES)
def test_every_row_in_exactly_one_block(case):
    b, s, t, h, kv, d, causal, window = case
    plan = fa.fma_forward_plan(*case)
    n_rows, n_bkv = s * (h // kv), b * kv
    assert plan["blocks"] == plan["row_tiles"] * n_bkv == len(plan["tiles"]) * n_bkv
    seen = np.zeros((n_bkv, n_rows), dtype=np.int64)
    for block in range(plan["blocks"]):
        bkv, r0, r1 = _block_rows(plan, n_bkv, block)
        assert r1 - r0 <= plan["rows"]
        seen[bkv, r0:r1] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("case", FMA_CASES)
def test_row_tiles_latest_first_and_causal_work_does_not_grow(case):
    plan = fa.fma_forward_plan(*case)
    starts = [tile[0] for tile in plan["tiles"]]
    assert starts == sorted(starts, reverse=True) and len(set(starts)) == len(starts)
    assert starts[-1] == 0
    causal, window = case[6], case[7]
    if causal and not window:
        n_kt = [tile[3] for tile in plan["tiles"]]
        assert n_kt == sorted(n_kt, reverse=True)


@pytest.mark.parametrize("case", FMA_CASES)
def test_key_tiles_are_the_mask_reach(case):
    _b, _s, t, h, kv, _d, causal, window = case
    plan = fa.fma_forward_plan(*case)
    for r0, r1, kt0, n_kt in plan["tiles"]:
        assert set(range(kt0, kt0 + n_kt)) == _reach(r0, r1, h // kv, t, causal, window)


@pytest.mark.parametrize("case", FMA_CASES)
def test_layout_threads_and_shared_memory(case):
    d = case[5]
    plan, lay = fa.fma_forward_plan(*case), fa.fma_forward_layout(d)
    assert plan["rows"] % lay["row_step"] == 0 and 16 <= plan["rows"] <= lay["max_rows"]
    assert plan["threads"] == plan["rows"] // 4 * lay["kg"] <= 256
    assert plan["threads"] % 32 == 0
    assert plan["smem_bytes"] <= 232_448 and plan["blocks_per_sm"] >= 1
    # the largest row tile whose grid keeps FMA_FWD_FILL_BLOCKS blocks
    n_rows, n_bkv = case[1] * (case[3] // case[4]), case[0] * case[4]
    bigger = plan["rows"] + lay["row_step"]
    if bigger <= lay["max_rows"]:
        assert -(-n_rows // bigger) * n_bkv < fa.FMA_FWD_FILL_BLOCKS
    if plan["rows"] > fa.FMA_FWD_MIN_ROWS:
        assert plan["blocks"] >= fa.FMA_FWD_FILL_BLOCKS


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_register_tiles_keep_four_fma_a_shared_load(d):
    """S: 4 rows x ak keys from 4 + ak 128-bit loads per 4 d; PV: 4 rows x
    cpt columns from 4 loads of P and 4 cpt / vec loads of V per 4 keys."""
    lay = fa.fma_forward_layout(d)
    assert lay["kg"] * lay["ak"] == fa.KV_TILE and lay["kg"] * lay["cpt"] == d
    assert lay["cpt"] % lay["vec"] == 0
    s_fma, s_loads = 4 * 4 * lay["ak"], 4 + lay["ak"]
    pv_fma, pv_loads = 4 * 4 * lay["cpt"], 4 + 4 * lay["cpt"] // lay["vec"]
    assert s_fma / s_loads >= 4 and pv_fma / pv_loads >= 4


def test_train_lm_grid_is_one_wave_of_small_row_tiles():
    """train_lm's attention: the row tile shrinks below 64 (the 64-row tile
    of the first port left one block 3 key tiles x 64 rows of work, twice
    the launch's bound) to 48 rows, and the grid, 192 blocks, fits one
    wave of an H100 (two blocks an SM by shared memory)."""
    plan = fa.fma_forward_plan(*TRAIN_LM)
    assert plan["rows"] == 48 and plan["threads"] == 192 and plan["blocks"] == 192
    assert plan["blocks"] <= fa.H100_SMS * plan["blocks_per_sm"]
    assert plan["waves"] <= 1


def test_main_f32_shape_takes_the_largest_row_tile():
    plan = fa.fma_forward_plan(1, 2048, 2048, 32, 8, 128, True, 0)
    assert plan["rows"] == 128 and plan["threads"] == 256


# ---------------------------------------------------------------------------
# Delta
# ---------------------------------------------------------------------------

def _do_o(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    o = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    do = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    return o, do


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_delta_order_matches_plain_delta(d, dtype):
    o, do = _do_o(d, (2, 37, 6, d), dtype)
    got = fa.delta_in_kernel_order(o, do)
    want = fa.flash_attention_bwd_delta(o, do)          # the plain version on the CPU
    assert got.shape == want.shape == (2, 6, 37) and got.dtype == torch.float32
    scale = float((do.float() * o.float()).abs().sum(-1).max())
    assert float((got - want).abs().max()) <= 1e-6 * scale


def _lane_loop(o: np.ndarray, do: np.ndarray, e: int) -> np.ndarray:
    """Delta's kernel for one row at a time, lane by lane, in numpy float32."""
    d = o.shape[-1]
    chunks = d // e
    lanes = 1
    while lanes < chunks:
        lanes *= 2
    out = np.empty(o.shape[:-1], dtype=np.float32)
    for idx in np.ndindex(*o.shape[:-1]):
        sums = []
        for lane in range(lanes):
            if lane < chunks:
                p = [np.float32(do[idx][lane * e + i]) * np.float32(o[idx][lane * e + i])
                     for i in range(e)]
            else:
                p = [np.float32(0.0)] * e
            while len(p) > 1:
                p = [np.float32(p[2 * i] + p[2 * i + 1]) for i in range(len(p) // 2)]
            sums.append(p[0])
        width = lanes // 2
        while width:
            sums = [np.float32(sums[i] + sums[i + width]) for i in range(width)]
            width //= 2
        out[idx] = sums[0]
    return out


@pytest.mark.parametrize("d", [16, 64, 112])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_delta_order_is_the_lane_loop_bit_for_bit(d, dtype):
    o, do = _do_o(3 * d, (1, 5, 3, d), dtype)
    got = fa.delta_in_kernel_order(o, do).numpy()
    e = 16 // o.element_size()
    want = _lane_loop(o.float().numpy(), do.float().numpy(), e).transpose(0, 2, 1)
    assert np.array_equal(got.view(np.int32), np.ascontiguousarray(want).view(np.int32))


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_delta_plan(d, dtype):
    e = 16 // dtype.itemsize
    for n_rows in (1, 9216, 65536, 10**7):
        plan = fa.delta_plan(dtype, d, n_rows)
        lanes = plan["lanes"]
        assert lanes >= d // e and lanes & (lanes - 1) == 0 and 32 % lanes == 0
        assert lanes < 2 * (d // e) and plan["rows_per_warp"] * lanes == 32
        assert plan["passes"] * plan["rows_per_warp"] * fa.DELTA_GROUPS >= n_rows
        assert 1 <= plan["warps"] <= fa.DELTA_MAX_WARPS
        # at most one wave; every pass has a warp of its own unless the wave is full
        assert plan["blocks"] * plan["warps"] <= fa.DELTA_SMS * fa.DELTA_SM_WARPS
        if plan["blocks"] * plan["warps"] < plan["passes"]:
            assert plan["blocks"] == fa.DELTA_SMS * (fa.DELTA_SM_WARPS // plan["warps"])
        # about one block an SM below the largest block
        if plan["warps"] < fa.DELTA_MAX_WARPS:
            assert plan["blocks"] <= fa.DELTA_SMS


def test_delta_train_lm_grid():
    """train_lm's Delta (9216 rows, D = 64, float32): 16 lanes a row, two
    rows a warp, 2304 passes of 4 rows on 128 blocks of 18 warps, one block
    an SM; Qwen3-8B's (65536 rows, D = 128, bf16): a full wave, 264 blocks
    of 32 warps, each warp two passes or one."""
    assert fa.delta_plan(F32, 64, 4 * 192 * 12) == dict(
        lanes=16, rows_per_warp=2, passes=2304, warps=18, blocks=128)
    assert fa.delta_plan(BF16, 128, 2048 * 32) == dict(
        lanes=16, rows_per_warp=2, passes=16384, warps=32, blocks=264)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_delta_variant(dtype):
    assert fa.delta_variant(dtype, 64, True) == "vec16"
    assert fa.delta_variant(dtype, 64, False) == "scalar"
    assert fa.DELTA_VARIANTS == ("vec16", "scalar")


def test_delta_on_the_cpu_counts_no_launch():
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    o, do = _do_o(0, (1, 4, 2, 16), F32)
    fa.flash_attention_bwd_delta(o, do)
    assert ops.launch_counts_bwd_delta_by_variant() == {
        dt: {"vec16": 0, "scalar": 0} for dt in ("float32", "bfloat16")}
    assert ops.launch_counts()["flash_attention_bwd_delta"] == 0
