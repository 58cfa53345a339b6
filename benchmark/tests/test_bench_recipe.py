"""The copied data recipe against chip_smoke's make_alignment."""

import sys

import numpy as np

from harness import inputs, layout
from reference.encoding import ENCODE


def _recipe():
    lay = layout.Layout()
    cfg = lay.config("sarscov2-8k")
    return lay.recipe(cfg["recipe"]), cfg


def test_recipe_is_chip_smokes_alignment_in_characters():
    had_jax = "jax" in sys.modules
    import chip_smoke

    try:
        recipe, cfg = _recipe()
        cfg = dict(cfg, sites=517)
        for seed in (0, 3, 2 ** 31 + 5):
            chars = recipe.make(cfg, 64, seed)
            assert chars.shape == (64, 517)
            np.testing.assert_array_equal(
                ENCODE[chars], chip_smoke.make_alignment(64, 517, seed))
    finally:
        if not had_jax and sys.modules.get("jax", 0) is None:
            del sys.modules["jax"]


def test_same_seed_same_matrix_and_ids():
    recipe, cfg = _recipe()
    cfg = dict(cfg, sites=300)
    a, b = recipe.make(cfg, 50, 7), recipe.make(cfg, 50, 7)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, recipe.make(cfg, 50, 8))
    ids = inputs.make_ids(cfg, 50, 7)
    assert ids == inputs.make_ids(cfg, 50, 7)
    assert len(set(ids)) == 50
    assert all(len(i) == 15 and i.startswith(b"EPI_ISL_") for i in ids)


def test_sample_holds_header_ends_and_draws():
    lines = inputs.sample_lines(10_000, 100, 5)
    assert lines[0] == 0 and 1 in lines and 10_000 in lines
    assert len(lines) >= 100 and np.all(np.diff(lines) > 0)
    np.testing.assert_array_equal(lines, inputs.sample_lines(10_000, 100, 5))
    assert len(inputs.sample_lines(20, 100, 5)) == 21
