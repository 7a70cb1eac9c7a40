"""The port's ``random`` (threefry2x32) against ``jax.random``, on the CPU.

Keys, splits, folds, words and uniforms must equal jax's uint32 words
bit for bit; gumbels agree within 2 ulp (the two logs are the CPU's, an
ulp apart at most); categorical draws, raw and through every sampler's
mask, give jax's tokens (``sampled_parity``'s near-tie rule).  The port
runs the plain versions of its kernels, which is what the wrappers do
for CPU tensors.  Also: the known-answer words ``chip_smoke.py`` holds
the card's kernels against were produced here from jax.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_np_cp_tpu.ops import sampling as jsamp
from llm_np_cp_tpu_torch import random as tr
from llm_np_cp_tpu_torch.ops import sampling as tsamp
from llm_np_cp_tpu_torch.ops.cuda import threefry
from sampled_parity import assert_prefix_parity, draw_margins

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEEDS = [0, 1, 42, 2**31 - 1, -12345]
SHAPES = [(1,), (3, 5), (4, 128256)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Elementwise int64 ops gain little from intra-op threads beside
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def words(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def test_jax_draws_in_the_mode_the_port_follows():
    """A jax upgrade that changes the mode fails here first."""
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_high_dynamic_range_gumbel is False  # gumbel mode "low"
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_enable_x64 is False


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    np.testing.assert_array_equal(words(tr.PRNGKey(seed)), np.asarray(jax.random.PRNGKey(seed)))
    seeds = np.asarray([seed, 7, 0], np.int64)
    got = tr.PRNGKey(torch.from_numpy(seeds))
    want = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds & 0xFFFFFFFF, jnp.uint32))
    np.testing.assert_array_equal(words(got), np.asarray(want))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3, 7])
def test_split_matches_jax(seed, num):
    got = tr.split(tr.PRNGKey(seed), num)
    np.testing.assert_array_equal(words(got),
                                  np.asarray(jax.random.split(jax.random.PRNGKey(seed), num)))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_matches_jax(seed):
    key, jkey = tr.PRNGKey(seed), jax.random.PRNGKey(seed)
    for data in (0, 7, 2**31 + 5, 4294967295):
        np.testing.assert_array_equal(words(tr.fold_in(key, data)),
                                      np.asarray(jax.random.fold_in(jkey, data)))
    # a key a row, as the serve engine derives them: fold_in(PRNGKey(seed), pos)
    seeds = np.asarray([seed & 0xFFFFFFFF, 3, 2**32 - 1], np.uint32)
    pos = np.asarray([0, 17, 100000], np.int32)
    got = tr.fold_in(tr.PRNGKey(torch.from_numpy(seeds.view(np.int32))), torch.from_numpy(pos))
    want = jax.vmap(lambda s, t: jax.random.fold_in(jax.random.PRNGKey(s), t))(
        jnp.asarray(seeds), jnp.asarray(pos))
    np.testing.assert_array_equal(words(got), np.asarray(want))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_matches_jax(seed, shape):
    got = tr.random_bits(tr.PRNGKey(seed), shape)
    assert got.shape == shape and got.dtype == torch.int32
    np.testing.assert_array_equal(words(got),
                                  np.asarray(jax.random.bits(jax.random.PRNGKey(seed), shape)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_matches_jax(seed, shape):
    key, jkey = tr.PRNGKey(seed), jax.random.PRNGKey(seed)
    for lo, hi in ((0.0, 1.0), (float(np.finfo(np.float32).tiny), 1.0), (-2.0, 3.0)):
        got = tr.uniform(key, shape, lo, hi)
        want = np.asarray(jax.random.uniform(jkey, shape, minval=lo, maxval=hi))
        np.testing.assert_array_equal(words(got), want.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_per_row_draws_match_jax_vmap(seed):
    """Keys [N, 2] key each row with counters from 0, as ``jax.vmap``
    over one key a row does (the engine's rows; ``sample_cdf``'s
    uniform)."""
    keys = tr.split(tr.PRNGKey(seed), 4)
    jkeys = jax.random.split(jax.random.PRNGKey(seed), 4)
    np.testing.assert_array_equal(
        words(tr.random_bits(keys, (4, 33))),
        np.asarray(jax.vmap(lambda k: jax.random.bits(k, (33,)))(jkeys)))
    np.testing.assert_array_equal(
        words(tr.uniform(keys, (4, 1))),
        np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (1,)))(jkeys)).view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_2_ulp_of_jax(seed):
    """Within 2 ulp of max(|jax's|, 1): below 1 the outer log's input is
    ~1 and carries the inner log's last-bit difference at that scale."""
    got = tr.gumbel(tr.PRNGKey(seed), (4, 128256)).numpy()
    want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), (4, 128256)))
    ulp = np.spacing(np.maximum(np.abs(want), np.float32(1.0)))
    assert (np.abs(got - want) <= 2 * ulp).all()


SAMPLERS = [jsamp.Sampler("greedy"), jsamp.Sampler("min_p", p_base=0.05),
            jsamp.Sampler("top_k", top_k=20), jsamp.Sampler("top_p", top_p=0.9),
            jsamp.Sampler("min_p", temperature=0.7), jsamp.Sampler("cdf", temperature=1.3)]


def _logits(seed, shape, scale=3.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("js", SAMPLERS, ids=lambda s: f"{s.kind}_t{s.temperature}")
def test_sampler_draws_match_jax(seed, js):
    """``Sampler(key, logits)`` under one key over [4, 128256] and under
    a key a row (the engine's form) gives jax's tokens."""
    ts = tsamp.Sampler(js.kind, temperature=js.temperature, p_base=js.p_base,
                       top_k=js.top_k, top_p=js.top_p)
    logits = _logits(seed & 0xFFFF, (4, 128256))
    key, jkey = tr.PRNGKey(seed), jax.random.PRNGKey(seed)
    want = np.asarray(js(jkey, jnp.asarray(logits)))
    got = ts(key if js.kind != "greedy" else None, torch.from_numpy(logits)).numpy()
    margins = draw_margins(js, jkey, logits) if js.kind != "greedy" else np.full(4, np.inf)
    assert_prefix_parity(want[:, None], got[:, None], margins[:, None], "one key")
    jkeys = jax.random.split(jkey, 4)
    want_rows = np.asarray(jax.vmap(lambda k, lg: js(k, lg[None])[0])(jkeys, logits))
    got_rows = ts(tr.split(key, 4), torch.from_numpy(logits)).numpy()
    margins = np.asarray([draw_margins(js, k, logits[n:n + 1])[0] if js.kind != "greedy"
                          else np.inf for n, k in enumerate(jkeys)])
    assert_prefix_parity(want_rows[:, None], got_rows[:, None], margins[:, None], "key a row")


@pytest.mark.parametrize("seed", SEEDS)
def test_categorical_matches_jax(seed):
    """Raw logits (no mask) at a narrow and a vocab-wide row, and a row
    of equal logits (the gumbel draws break the tie as jax's do)."""
    key, jkey = tr.PRNGKey(seed), jax.random.PRNGKey(seed)
    for shape in ((6, 50), (2, 256000)):
        logits = _logits(seed & 0xFFFF, shape, 1.0)
        want = np.asarray(jax.random.categorical(jkey, logits))
        got = tr.categorical(key, torch.from_numpy(logits)).numpy()
        assert got.dtype == np.int32
        assert_prefix_parity(want[:, None], got[:, None],
                             draw_margins(None, jkey, logits)[:, None], f"categorical {shape}")
    flat = np.zeros((3, 40), np.float32)
    np.testing.assert_array_equal(tr.categorical(key, torch.from_numpy(flat)).numpy(),
                                  np.asarray(jax.random.categorical(jkey, flat)))


@pytest.mark.parametrize("js", [s for s in SAMPLERS if s.kind in ("min_p", "cdf")],
                         ids=lambda s: f"{s.kind}_t{s.temperature}")
@pytest.mark.parametrize("row0", [1, 2])
def test_sampler_rows_from_row0_draw_the_whole_batchs_bits(js, row0):
    """A data-parallel rank's rows (``row0`` on, one key): the tokens of
    the whole batch's draw at those rows, jax's included."""
    ts = tsamp.Sampler(js.kind, temperature=js.temperature, p_base=js.p_base)
    logits = _logits(row0, (4, 5000))
    key, jkey = tr.PRNGKey(17), jax.random.PRNGKey(17)
    whole = ts(key, torch.from_numpy(logits)).numpy()
    part = ts(key, torch.from_numpy(logits[row0:row0 + 2]), row0).numpy()
    np.testing.assert_array_equal(part, whole[row0:row0 + 2])
    want = np.asarray(js(jkey, jnp.asarray(logits)))[row0:row0 + 2]
    margins = draw_margins(js, jkey, logits)[row0:row0 + 2]
    assert_prefix_parity(want[:, None], part[:, None], margins[:, None], f"row0 {row0}")


def test_min_p_matches_jax():
    """``ops.sampling.min_p`` (the reference's live sampler) is jax's."""
    logits = _logits(5, (5, 300))
    for seed, p_base in ((3, 0.1), (9, 0.02)):
        jkey = jax.random.PRNGKey(seed)
        want = np.asarray(jsamp.min_p(jkey, jnp.asarray(logits), p_base))
        got = tsamp.min_p(tr.PRNGKey(seed), torch.from_numpy(logits), p_base).numpy()
        margins = draw_margins(jsamp.Sampler("min_p", p_base=p_base), jkey, logits)
        assert_prefix_parity(want[:, None], got[:, None], margins[:, None], "min_p")


def test_wrappers_check_their_arguments():
    key = tr.PRNGKey(0)
    with pytest.raises(ValueError, match="one key"):
        tr.split(tr.split(key, 2), 2)
    with pytest.raises(ValueError, match="shape\\[0\\] == N"):
        tr.random_bits(tr.split(key, 3), (4, 2))
    with pytest.raises(ValueError, match="int32"):
        tr.uniform(key.long(), (2,))
    with pytest.raises(ValueError, match="pair up"):
        tr.fold_in(tr.split(key, 3), torch.zeros(2, dtype=torch.int32))
    # CPU tensors take the plain versions, and count no launch
    before = (threefry.threefry2x32.launches, threefry.categorical.launches)
    tr.categorical(key, torch.zeros(2, 9))
    assert (threefry.threefry2x32.launches, threefry.categorical.launches) == before


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_known_answers_match_jax():
    """The words and tokens ``chip_smoke.py`` holds the card's kernels
    against (the card has no jax) are jax's, and its categorical case's
    draws are clear of near-ties."""
    ka = _chip_smoke().KNOWN_ANSWERS
    key = jax.random.PRNGKey(ka["seed"])
    assert np.asarray(jax.random.split(key, 3)).tolist() == ka["split3"]
    assert np.asarray(jax.random.fold_in(key, ka["fold_data"])).tolist() == ka["fold_in"]
    assert np.asarray(jax.random.bits(key, (8,))).tolist() == ka["bits8"]
    u = np.asarray(jax.random.uniform(key, (8,))).view(np.uint32)
    assert u.tolist() == ka["uniform8_words"]
    n, v = ka["categorical_shape"]
    flat = np.asarray(jax.random.bits(key, (n, v))).reshape(-1)
    assert flat[ka["wide_index"]].tolist() == ka["bits_wide"]
    logits = ((np.arange(n * v, dtype=np.int64) * 7919) % 1000 / 100.0 - 5.0).astype(
        np.float32).reshape(n, v)
    assert np.asarray(jax.random.categorical(key, logits)).tolist() == ka["categorical"]
    jkeys = jax.random.split(key, n)
    rows = jax.vmap(lambda k, lg: jax.random.categorical(k, lg[None])[0])(jkeys, logits)
    assert np.asarray(rows).tolist() == ka["categorical_rows"]
    assert draw_margins(None, key, logits).min() > 1e-3
    assert min(draw_margins(None, k, logits[i:i + 1])[0] for i, k in enumerate(jkeys)) > 1e-3
