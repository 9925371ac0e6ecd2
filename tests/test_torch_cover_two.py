"""Kernel I, the page cover at group caps above 128. On the card it is one
launch of kernel B's body (`cover_cuda.fused_cover`); its plain version is
the TPU's two-kernel structure, `texcache._cover_and_match_2level` over
`cover_two.block_cover_reference` and `pix_match_reference` around the
tile-level distinct sort (`texcache._distinct_by_sort`). Everything against
the JAX package's `texcache.py` in interpret mode, bit for bit:

* each plain half against its TPU kernel (`_block_cover_pallas`,
  `_pix_match_pallas`);
* `_distinct_by_sort` against the JAX glue (a stable sort both sides);
* the port's route at caps above 128 (`texcache._cover_and_match`, one
  `fused_cover` call at such a cap) against
  `_cover_and_match_2level(kernel=True)`, per-group caps included: all four
  outputs;
* kernel B's plain version (`cover_cuda.fused_cover_reference`, what the
  wrapper runs on the CPU) against both the two-level plain route and the
  JAX result on every case at caps above 128;
* the two-level plain route at caps up to 128 against kernel B's plain
  version: all four outputs, so the two plain versions agree at every cap.
"""

import functools


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from direct12pbrrenderer_tpu.ops import texcache as jtex
from chip_smoke import recording
from direct12pbrrenderer_tpu_torch.ops import cover_cuda, cover_two, texcache

torch.set_num_threads(2)


def _case(name):
    """(pages, act, caps, block_cap) at 8 rows per tile."""
    rng = np.random.default_rng(41)
    tiles, g, blocks = 3, 3, 8
    shape = (tiles, g, blocks, 128)
    if name == "wide":                 # up to 32 distinct pages a row, 256 per tile
        pages = rng.integers(0, 400, shape)
        act = rng.random(shape) > 0.1
        return pages, act, (156, 156, 156), 32
    if name == "per_group":            # per-group caps above and below the demand
        pages = rng.integers(0, 300, shape)
        act = rng.random(shape) > 0.2
        return pages, act, (156, 44, 132), 24
    if name == "empty":                # all-inactive tiles and groups
        pages = rng.integers(0, 500, shape)
        act = rng.random(shape) > 0.3
        act[0] = False
        act[2, 1] = False
        return pages, act, (140, 140, 140), 32
    if name == "coherent":             # row-coherent pages, the frame's regime
        base = rng.integers(0, 400, (tiles, g, 1, 1))
        pages = base + np.arange(128)[None, None, None, :] // 16 + rng.integers(0, 2, shape)
        return pages, rng.random(shape) > 0.1, (92, 44, 92), 16
    if name == "small_caps":           # caps clamp count and slot
        return rng.integers(0, 40, shape), rng.random(shape) > 0.3, (16, 8, 4), 4
    # more distinct pages per row than block_cap
    return rng.integers(0, 3000, shape), np.ones(shape, bool), (44, 44, 44), 8


CASES = ["wide", "per_group", "empty", "coherent", "small_caps", "adversarial"]


def _np(*xs):
    return [np.asarray(x) for x in xs]


def _wide_case(name):
    """`_case(name)` with its first group's cap lifted above 128 where no cap
    is (per-group caps: the other groups' still clamp), and block_cap raised
    where the rows' candidates could not fill that cap (the JAX glue's list
    is a slice of the blocks * block_cap candidates)."""
    pages, act, caps, block_cap = _case(name)
    if max(caps) <= 128:
        caps = (caps[0] + 128,) + caps[1:]
    block_cap = max(block_cap, -(-max(caps) // pages.shape[2]))
    return pages.astype(np.int32), act, caps, block_cap


@functools.lru_cache(maxsize=None)
def _jax_wide(name):
    """JAX's two-kernel cover (`kernel=True`, interpret mode) of
    `_wide_case(name)`: (list, count, slot, covered) as numpy arrays."""
    pages, act, caps, block_cap = _wide_case(name)
    return tuple(_np(*jtex._cover_and_match_2level(jnp.asarray(pages), jnp.asarray(act), caps,
                                                   block_cap, kernel=True, interpret=True)))


@pytest.mark.parametrize("name", ["wide", "per_group", "empty", "adversarial"])
def test_block_cover_and_pix_match_match_tpu_kernels(name):
    pages, act, caps, block_cap = _case(name)
    pages = pages.astype(np.int32)
    cand_j, slot_a_j = jtex._block_cover_pallas(jnp.asarray(pages), jnp.asarray(act),
                                                block_cap, interpret=True)
    cand, slot_a = cover_two.block_cover_reference(torch.as_tensor(pages), torch.as_tensor(act),
                                                   block_cap)
    np.testing.assert_array_equal(cand.numpy(), np.asarray(cand_j), "cand")
    np.testing.assert_array_equal(slot_a.numpy(), np.asarray(slot_a_j), "slotA")
    # the match on random row ranks: slotB (…, block_cap), foundB
    rng = np.random.default_rng(3)
    slot_b = rng.integers(0, max(caps), cand.shape).astype(np.int32)
    found_b = rng.random(cand.shape) > 0.3
    want = jtex._pix_match_pallas(slot_a_j, jnp.asarray(slot_b), jnp.asarray(found_b),
                                  block_cap, interpret=True)
    got = cover_two.pix_match_reference(slot_a, torch.as_tensor(slot_b),
                                        torch.as_tensor(found_b), block_cap)
    for w, g_, what in zip(_np(*want), got, ("slot", "covered")):
        np.testing.assert_array_equal(g_.numpy(), w, what)
    if name == "adversarial":          # rows really overflowed their block_cap
        assert (slot_a.numpy() == block_cap).any()


@pytest.mark.parametrize("name", ["wide", "per_group", "empty"])
def test_distinct_by_sort_matches_jax(name):
    pages, act, caps, block_cap = _case(name)
    cand, _ = cover_two.block_cover_reference(torch.as_tensor(pages.astype(np.int32)),
                                              torch.as_tensor(act), block_cap)
    flat = cand.reshape(cand.shape[0], cand.shape[1], -1)
    cap_arr = np.asarray(caps, np.int32)[None, :]
    want = jtex._distinct_by_sort(jnp.asarray(flat.numpy()), max(caps), jnp.asarray(cap_arr))
    got = texcache._distinct_by_sort(flat, max(caps), torch.as_tensor(cap_arr))
    for w, g_, what in zip(_np(*want), got, ("list", "count", "slot", "found")):
        np.testing.assert_array_equal(g_.numpy(), w, what)
    # one shared cap (cap_arr None)
    want = jtex._distinct_by_sort(jnp.asarray(flat.numpy()), 140)
    got = texcache._distinct_by_sort(flat, 140)
    for w, g_, what in zip(_np(*want), got, ("list", "count", "slot", "found")):
        np.testing.assert_array_equal(g_.numpy(), w, what)


@pytest.mark.parametrize("name", ["wide", "per_group", "empty"])
def test_cover_above_128_matches_jax_two_kernel_cover(name):
    """The port's route: one `fused_cover` call at the cap above 128 (kernel
    I's launch on the card, its plain version here), all four outputs equal
    to the JAX package's two-kernel cover."""
    pages, act, caps, block_cap = _wide_case(name)
    with recording(cover_cuda, "fused_cover") as calls:
        got = texcache._cover_and_match(torch.as_tensor(pages), torch.as_tensor(act), caps,
                                        block_cap)
    (args, _), = calls
    assert tuple(args[2]) == caps and max(args[2]) > cover_cuda.WIDE_CAP
    for w, g_, what in zip(_jax_wide(name), got, ("list", "count", "slot", "covered")):
        np.testing.assert_array_equal(g_.numpy(), w, what)
    counts = got[1].numpy()
    if name == "wide":                 # the tile lists really exceed 128 pages
        assert (counts > 128).any()
    if name == "per_group":            # a count clamped to its cap
        assert (counts == np.asarray(caps)[None, :]).any()


@pytest.mark.parametrize("name", CASES)
def test_kernel_b_plain_version_is_kernel_i_above_128(name):
    """At caps above 128 kernel B's plain version equals kernel I's (the
    two-level plain route) and the JAX package's two-kernel cover on all
    four outputs."""
    pages, act, caps, block_cap = _wide_case(name)
    p, a = torch.as_tensor(pages), torch.as_tensor(act)
    got = cover_cuda.fused_cover_reference(p, a, caps, block_cap)
    plain_i = texcache._cover_and_match_2level(p, a, caps, block_cap)
    for g_, i_, w, what in zip(got, plain_i, _jax_wide(name),
                               ("list", "count", "slot", "covered")):
        assert g_.dtype == i_.dtype and g_.shape == i_.shape, what
        assert torch.equal(g_, i_), what
        np.testing.assert_array_equal(g_.numpy(), w, what)
    assert got[0].shape[-1] == max(caps) > 128
    if name in ("wide", "empty"):      # tiles with more than 128 distinct pages
        assert (got[1] > 128).any()
    if name == "empty":                # all-inactive items are all zero
        assert not got[0][0].any() and not got[1][0].any() and not got[3][0].any()


@pytest.mark.parametrize("name", ["coherent", "small_caps", "adversarial", "empty"])
def test_two_kernel_route_equals_kernel_b_up_to_128(name):
    pages, act, caps, block_cap = _case(name)
    caps = tuple(min(c, 128) for c in caps)
    p, a = torch.as_tensor(pages.astype(np.int32)), torch.as_tensor(act)
    want = cover_cuda.fused_cover_reference(p, a, caps, block_cap)
    got = texcache._cover_and_match_2level(p, a, caps, block_cap)
    for w, g_, what in zip(want, got, ("list", "count", "slot", "covered")):
        assert g_.dtype == w.dtype and g_.shape == w.shape, what
        assert torch.equal(g_, w), what
