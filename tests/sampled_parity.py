"""The near-tie rule of the sampled parity tests (JAX against the port).

The port draws ``jax.random``'s bits, so a sampled token equals the JAX
package's wherever the two see the same logits.  They see them to within
float32 summation order (~1e-6), and their logs may differ by an ulp, so
a draw whose best two candidates are closer than ``NEAR_TIE`` on the JAX
side may go either way.  Each test therefore holds each row to JAX's
tokens up to the first token where they part, which must be a near-tie
on the JAX side (its margin is printed): the prefix before a near-tie is
compared, and one drawn alike leaves the rest comparable.  No seed is
picked to dodge one.

The margin of a Gumbel-max draw is the top-2 gap of ``gumbel(key) +
filtered logits``; of an inverse-CDF draw, the distance from the uniform
to the nearest CDF value.  Logits come from a cache-less JAX forward over
the prompt and the JAX side's own tokens (teacher-forced).
"""

import jax
import jax.numpy as jnp
import numpy as np

from llm_np_cp_tpu.models import transformer as jtf

NEAR_TIE = 1e-4


def draw_margins(sampler, key, logits) -> np.ndarray:
    """The JAX side's margin of ``sampler(key, logits)`` per row of
    ``logits [N, V]`` (one key over the whole array, as the sampler
    draws); ``sampler`` None: ``jax.random.categorical`` of the raw
    logits."""
    logits = jnp.asarray(logits, jnp.float32)
    if sampler is None:
        z = jax.random.gumbel(key, logits.shape, jnp.float32) + logits
        top2 = jax.lax.top_k(z, 2)[0]
        return np.asarray(top2[:, 0] - top2[:, 1])
    if sampler.kind == "cdf":
        if sampler.temperature != 1.0:
            logits = logits / sampler.temperature
        cdf = jnp.cumsum(jax.nn.softmax(logits, axis=-1), axis=-1)
        u = jax.random.uniform(key, logits.shape[:-1] + (1,), dtype=jnp.float32)
        return np.asarray(jnp.min(jnp.abs(cdf - u), axis=-1))
    z = jax.random.gumbel(key, logits.shape, jnp.float32) + sampler.filtered_logits(logits)
    top2 = jax.lax.top_k(z, 2)[0]
    return np.asarray(top2[:, 0] - top2[:, 1])


def teacher_logits(jp, jcfg, prompt, toks) -> np.ndarray:
    """JAX logits ``[B, n, V]`` behind each of ``toks [B, n]`` after
    ``prompt [B, S]`` (a cache-less forward)."""
    ids = np.concatenate([np.asarray(prompt), np.asarray(toks)[:, :-1]], axis=1)
    logits, _ = jtf.forward(jp, jnp.asarray(ids, jnp.int32), jcfg, None)
    return np.asarray(logits)[:, np.asarray(prompt).shape[1] - 1:]


def generate_margins(jp, jcfg, sampler, prompts, toks, seed) -> np.ndarray:
    """Margins ``[B, n]`` of ``Generator.generate``: the prefill draws
    under ``k_pre``, step i under ``split(k_loop, n - 1)[i]``."""
    k_pre, k_loop = jax.random.split(jax.random.PRNGKey(seed))
    n = toks.shape[1]
    keys = [k_pre] + (list(jax.random.split(k_loop, n - 1)) if n > 1 else [])
    logits = teacher_logits(jp, jcfg, prompts, toks)
    return np.stack([draw_margins(sampler, k, logits[:, t]) for t, k in enumerate(keys)], 1)


def stream_margins(jp, jcfg, sampler, prompt, toks, seed) -> np.ndarray:
    """Margins ``[n]`` of ``Generator.stream``: ``key, k = split(key)``
    before the prefill and before every step."""
    key = jax.random.PRNGKey(seed)
    logits = teacher_logits(jp, jcfg, np.asarray(prompt)[None], np.asarray(toks)[None])[0]
    out = []
    for t in range(len(toks)):
        key, k = jax.random.split(key)
        out.append(draw_margins(sampler, k, logits[t:t + 1])[0])
    return np.asarray(out)


def request_margins(jp, jcfg, sampler, req) -> np.ndarray:
    """Margins ``[n]`` of a served request's tokens: the token at content
    position p draws under ``fold_in(PRNGKey(seed), p)`` over its row."""
    prompt = np.asarray(req.prompt)
    logits = teacher_logits(jp, jcfg, prompt[None], np.asarray(req.generated)[None])[0]
    base = jax.random.PRNGKey(np.uint32(req.seed & 0xFFFFFFFF))
    return np.asarray([
        draw_margins(sampler, jax.random.fold_in(base, prompt.size - 1 + t), logits[t:t + 1])[0]
        for t in range(len(req.generated))])


def assert_prefix_parity(want, got, margins, where: str) -> int:
    """Row r of ``got`` equals row r of ``want`` (and has its length), or
    first differs from it at a token where the JAX side's margin
    ``margins[r][t]`` is a near-tie, which is printed: the prefix before
    a near-tie is compared, and a near-tie both sides drew alike leaves
    the rest comparable.  Returns the number of tokens compared."""
    compared = 0
    for r, (w, g, m) in enumerate(zip(want, got, margins)):
        w, g, m = list(w), list(g), list(m)
        d = next((t for t, (x, y) in enumerate(zip(w, g)) if x != y), None)
        if d is None:
            assert len(g) == len(w), f"{where} row {r}: {len(g)} tokens, JAX {len(w)}"
            compared += len(w)
            continue
        assert m[d] < NEAR_TIE, (f"{where} row {r}: {g} != JAX {w} at token {d}, "
                                 f"JAX top-2 margin {m[d]:.3g} (margins {m})")
        print(f"{where} row {r}: parts from JAX at token {d}, a near-tie (JAX top-2 margin "
              f"{m[d]:.3g} < {NEAR_TIE}); compared the {d} tokens before it")
        compared += d
    return compared


def spec_margins(target, draft, sampler, gamma, prompts, max_new, seed):
    """Replay the JAX ``SpeculativeGenerator``'s rounds cache-lessly
    (``target`` and ``draft``: (params, config) pairs; the same
    ``sampler`` drafts and verifies; equal-length ``prompts [B, S]``) and
    return (its tokens ``[B, max_new]``, each token's margin): the
    smallest margin among the draws that decided the round that emitted
    it — its draft draws, its accept tests (``|u q(d) - p(d)|``) and its
    correction draw — as JAX's ``_spec_round_core`` keys them."""
    b, s = np.asarray(prompts).shape
    width = s + max_new + 2 * (gamma + 1)  # ids padded at the end: causal rows ignore it

    def filtered_fn(params, cfg):
        @jax.jit
        def run(ids):
            return sampler.filtered_logits(jtf.forward(params, ids[None], cfg, None)[0][0])

        def at(seq):  # filtered logits [len(seq), V] behind each token of seq
            return np.asarray(run(jnp.asarray(seq + [0] * (width - len(seq)), jnp.int32)))[
                :len(seq)]
        return at

    tgt, dft = filtered_fn(*target), filtered_fn(*draft)

    def gumbel(k, v):
        return np.asarray(jax.random.gumbel(k, (b, v), jnp.float32))

    def top2_gap(z):
        return float(np.diff(np.sort(z)[-2:])[0])

    key, kp = jax.random.split(jax.random.PRNGKey(seed))
    first = np.stack([tgt(list(p))[-1] for p in np.asarray(prompts).tolist()])
    z = gumbel(kp, first.shape[1]) + first
    hist = [list(p) + [int(np.argmax(z[r]))] for r, p in enumerate(np.asarray(prompts).tolist())]
    marg = [[top2_gap(z[r])] for r in range(b)]
    while any(len(h) - s < max_new for h in hist):
        key, kr = jax.random.split(key)
        kd, ku, kc = jax.random.split(kr, 3)
        v = first.shape[1]
        gd = [gumbel(k, v) for k in jax.random.split(kd, gamma + 1)]
        gc = gumbel(kc, v)
        u = np.asarray(jax.random.uniform(ku, (b, gamma), dtype=jnp.float32))
        for r in range(b):
            if len(hist[r]) - s >= max_new:
                continue
            drafts, qs, m = [], [], []
            for i in range(gamma + 1):
                fl = dft(hist[r] + drafts)[-1]
                zi = gd[i][r] + fl
                drafts.append(int(np.argmax(zi)))
                m.append(top2_gap(zi))
                qs.append(np.asarray(jax.nn.softmax(fl)))
            ps = np.asarray(jax.nn.softmax(tgt(hist[r] + drafts[:gamma]), axis=-1))[
                len(hist[r]) - 1:]
            n = gamma
            for j in range(gamma):
                lhs, rhs = u[r, j] * qs[j][drafts[j]], ps[j][drafts[j]]
                m.append(abs(float(lhs - rhs)))
                if not lhs < rhs:
                    n = j
                    break
            q_n = qs[n] if n < gamma else np.zeros_like(ps[n])
            resid = np.maximum(ps[n] - q_n, 0.0)
            tot = resid.sum()
            zc = np.log((resid / max(tot, 1e-38) if tot > 0 else ps[n]) + 1e-38) + gc[r]
            m.append(top2_gap(zc))
            emitted = drafts[:n] + [int(np.argmax(zc))]
            hist[r] += emitted
            marg[r] += [min(m)] * len(emitted)
    toks = np.asarray([h[s:s + max_new] for h in hist])
    return toks, np.asarray([mm[:max_new] for mm in marg])
