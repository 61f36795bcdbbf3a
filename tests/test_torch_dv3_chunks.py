"""The chunked stored-state RSSM scan (``algo.rssm_chunks > 1`` with burn-in)
against the JAX package's ``chunked_dynamic_scan`` on converted weights, on
the CPU at a tiny width.

The JAX scan draws each folded step's noise from ``split(k_main, C)`` and
each burn-in step's from ``split(k_burn, burn_in)``, ``k_main, k_burn =
split(key)`` (``sheeprl_tpu/algos/dreamer_v3/utils.py:128, 152, 172``); the
test draws the same Gumbel noise, unfolds the main noise to the port's
``[T, B, ...]`` layout and hands both to the port.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v3.utils import chunked_dynamic_scan as jax_chunked_dynamic_scan
from sheeprl_tpu.algos.dreamer_v3.utils import rssm_scan_spec as jax_rssm_scan_spec
from sheeprl_tpu.data.slab import rssm_state_slab as jax_rssm_state_slab
from sheeprl_tpu_torch.algos.dreamer_v3.utils import RSSM_STATE_KEYS, _scan, chunked_dynamic_scan, rssm_scan_spec
from sheeprl_tpu_torch.data.slab import rssm_state_slab
from sheeprl_tpu_torch.utils.utils import dotdict
from test_torch_dv3_train import ATOL, DISCRETE, REC, STOCH, _record_margins, _Setup, _t
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

T, B = 8, 2
Z = STOCH * DISCRETE


@pytest.fixture(scope="module")
def setup():
    return _Setup("multidiscrete_dummy", (2, 2), False)


def _inputs(setup, seed: int = 3):
    """Actions, embeddings, ``is_first`` (an episode start on row 4, a chunk
    boundary at K=2 and K=4, in column 1) and stored states: one-hot
    posteriors, tanh recurrents, with the rows feeding boundaries 2 and 4 of
    column 0 and row 0 of column 1 (burn-in's initial row at K=4) invalid
    and poisoned."""
    rng = np.random.default_rng(seed)
    embed_dim = setup.agent().world_model.rssm.representation_model.stack.dense[0].in_features - REC
    actions = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (T, B, 2))].reshape(T, B, 4)
    embedded = rng.normal(size=(T, B, embed_dim)).astype(np.float32)
    is_first = np.zeros((T, B, 1), np.float32)
    is_first[0] = 1.0
    is_first[4, 1] = 1.0
    posterior = np.eye(DISCRETE, dtype=np.float32)[rng.integers(0, DISCRETE, (T, B, STOCH))].reshape(T, B, Z)
    recurrent = np.tanh(rng.normal(size=(T, B, REC))).astype(np.float32)
    valid = np.ones((T, B, 1), np.float32)
    for t, b in ((1, 0), (3, 0), (0, 1)):
        valid[t, b] = 0.0
        posterior[t, b] = 1e3
        recurrent[t, b] = 1e3
    return actions, embedded, is_first, recurrent, posterior, valid


def _jax_scan(setup, inputs, key, chunks, burn_in):
    wm_params = setup.params["world_model"]
    actions, embedded, is_first, recurrent, posterior, valid = inputs

    def body(carry, x):
        post, rec = carry
        rec, post, _, post_logits, prior_logits = setup.wm_def.apply(wm_params, post, rec, *x, method="dynamic")
        return (post, rec), (rec, post, post_logits, prior_logits)

    def scan(actions, embedded, is_first, recurrent, posterior, valid, key):
        return jax_chunked_dynamic_scan(
            body, actions, embedded, is_first, key, stoch_flat=Z, recurrent_size=REC, cdt=jnp.float32,
            chunks=chunks, burn_in=burn_in, stored_recurrent=recurrent, stored_posterior=posterior,
            stored_valid=valid,
        )

    return jax.jit(scan)(actions, embedded, is_first, recurrent, posterior, valid, key)


def _jax_noise(key, chunks: int, burn_in: int):
    """The (prior, posterior) noise of the main scan, unfolded to [T, B, ...],
    and of the burn-in steps, [burn_in, (K-1)*B, ...]."""
    K, C = chunks, T // chunks

    def pair(keys, rows):
        p = [jax.random.split(k) for k in keys]
        return (np.stack([np.array(jax.random.gumbel(k[0], (rows, STOCH, DISCRETE))) for k in p]),
                np.stack([np.array(jax.random.gumbel(k[1], (rows, STOCH, DISCRETE))) for k in p]))

    k_main, k_burn = jax.random.split(key)
    unfold = lambda y: y.reshape(C, K, B, STOCH, DISCRETE).swapaxes(0, 1).reshape(T, B, STOCH, DISCRETE)  # noqa: E731
    main = tuple(unfold(x) for x in pair(jax.random.split(k_main, C), K * B))
    burn = pair(jax.random.split(k_burn, burn_in), (K - 1) * B) if burn_in else None
    return main, burn


@pytest.mark.parametrize("chunks,burn_in", [(2, 0), (2, 1), (4, 0), (4, 1)])
def test_chunked_scan_matches_jax_with_invalid_rows_and_a_boundary_episode_start(setup, chunks, burn_in,
                                                                                  monkeypatch):
    inputs = _inputs(setup)
    key = jax.random.PRNGKey(11)
    want = _jax_scan(setup, inputs, key, chunks, burn_in)
    main, burn = _jax_noise(key, chunks, burn_in)
    _record_margins(monkeypatch)
    actions, embedded, is_first, recurrent, posterior, valid = (_t(x) for x in inputs)
    is_first_before = is_first.clone()
    with torch.no_grad():
        got = chunked_dynamic_scan(
            setup.agent().world_model, actions, embedded, is_first, stoch_flat=Z, recurrent_size=REC, chunks=chunks,
            burn_in=burn_in, stored_recurrent=recurrent, stored_posterior=posterior, stored_valid=valid,
            noise=tuple(_t(x) for x in main), burn_in_noise=None if burn is None else tuple(_t(x) for x in burn),
        )
    assert torch.equal(is_first, is_first_before), "the reset of an invalid chunk start wrote into the batch"
    for name, g, w in zip(("recurrents", "posteriors", "posterior_logits", "prior_logits"), got, want):
        assert tuple(g.shape) == tuple(np.shape(w))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=ATOL, err_msg=name)
    assert np.abs(got[0].numpy()).max() <= 1.0, "a poisoned stored state leaked into the scan"


def test_chunks_1_is_the_sequential_scan(setup):
    inputs = _inputs(setup)
    actions, embedded, is_first, recurrent, posterior, valid = (_t(x) for x in inputs)
    rng = np.random.default_rng(5)
    noise = tuple(_t(rng.gumbel(size=(T, B, STOCH, DISCRETE)).astype(np.float32)) for _ in range(2))
    wm = setup.agent().world_model
    with torch.no_grad():
        got = chunked_dynamic_scan(wm, actions, embedded, is_first, stoch_flat=Z, recurrent_size=REC, chunks=1,
                                   stored_recurrent=recurrent, stored_posterior=posterior, stored_valid=valid,
                                   noise=noise)
        post, rec = torch.zeros(B, Z), torch.zeros(B, REC)
        for t in range(T):
            rec, post, _, post_logits, prior_logits = wm.dynamic(post, rec, actions[t], embedded[t], is_first[t],
                                                                 None, (noise[0][t], noise[1][t]))
            for out, ref in zip(got, (rec, post, post_logits, prior_logits)):
                assert torch.equal(out[t], ref)


@pytest.mark.parametrize("burn_in", [0, 1])
def test_no_gradient_reaches_the_stored_states_or_through_the_burn_in(setup, burn_in):
    inputs = _inputs(setup)
    actions, embedded, is_first, recurrent, posterior, valid = (_t(x) for x in inputs)
    rng = np.random.default_rng(6)
    noise = tuple(_t(rng.gumbel(size=(T, B, STOCH, DISCRETE)).astype(np.float32)) for _ in range(2))
    burn_noise = tuple(_t(rng.gumbel(size=(burn_in, B, STOCH, DISCRETE)).astype(np.float32)) for _ in range(2))
    wm = setup.agent().world_model
    cot = [_t(rng.normal(size=s).astype(np.float32)) for s in ((T, B, REC), (T, B, Z))]

    def grads(stored_recurrent, stored_posterior, stored_valid, burn_in_):
        emb = embedded.clone().requires_grad_(True)
        rec, post = stored_recurrent.clone().requires_grad_(True), stored_posterior.clone().requires_grad_(True)
        out = chunked_dynamic_scan(wm, actions, emb, is_first, stoch_flat=Z, recurrent_size=REC, chunks=2,
                                   burn_in=burn_in_, stored_recurrent=rec, stored_posterior=post,
                                   stored_valid=stored_valid, noise=noise,
                                   burn_in_noise=burn_noise if burn_in_ else None)
        loss = (out[0] * cot[0]).sum() + (out[1] * cot[1]).sum()
        return torch.autograd.grad(loss, [emb, rec, post], allow_unused=True)

    g_emb, g_rec, g_post = grads(recurrent, posterior, valid, burn_in)
    assert g_rec is None and g_post is None
    if burn_in:
        # the burn-in's last state (row C-1, run from the valid state stored
        # at row C-2) handed in as the stored state of row C-1: the same
        # gradient, so none flowed through the burn-in
        C = T // 2
        assert bool(valid[C - 2].all())
        with torch.no_grad():
            _, (z, h) = _scan(wm, posterior[C - 2], recurrent[C - 2], actions[C - 1 : C], embedded[C - 1 : C],
                              is_first[C - 1 : C], None, burn_noise)
        manual_rec, manual_post, manual_valid = recurrent.clone(), posterior.clone(), valid.clone()
        manual_rec[C - 1], manual_post[C - 1], manual_valid[C - 1] = h, z, 1.0
        want = grads(manual_rec, manual_post, manual_valid, 0)[0]
        np.testing.assert_allclose(g_emb.numpy(), want.numpy(), atol=1e-6, rtol=1e-6)


def test_bad_options_raise_the_jax_errors(setup):
    wm = setup.agent().world_model
    actions, embedded, is_first, recurrent, posterior, valid = (_t(x) for x in _inputs(setup))
    common = dict(stoch_flat=Z, recurrent_size=REC)
    for kwargs, match in (
        (dict(chunks=3, stored_recurrent=recurrent, stored_posterior=posterior), "must divide the sequence length"),
        (dict(chunks=2, burn_in=4, stored_recurrent=recurrent, stored_posterior=posterior),
         r"algo.rssm_chunk_burn_in \(4\) must be in \[0, chunk_length\)"),
        (dict(chunks=2), "rssm_recurrent"),
    ):
        with pytest.raises(ValueError, match=match):
            chunked_dynamic_scan(wm, actions, embedded, is_first, **common, **kwargs)
        with pytest.raises(ValueError, match=match):
            jax_chunked_dynamic_scan(lambda c, x: (c, x), jnp.asarray(actions.numpy()), jnp.asarray(embedded.numpy()),
                                     jnp.asarray(is_first.numpy()), jax.random.PRNGKey(0), cdt=jnp.float32,
                                     **common, **{k: (jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v)
                                                  for k, v in kwargs.items()})
    for algo, match in (({"rssm_chunks": -1}, "rssm_chunks must be >= 1"),
                        ({"rssm_chunk_burn_in": -1}, "rssm_chunk_burn_in must be >= 0")):
        cfg = dotdict({"algo": algo})
        for spec in (rssm_scan_spec, jax_rssm_scan_spec):
            with pytest.raises(ValueError, match=match):
                spec(cfg)
    assert rssm_scan_spec(dotdict({"algo": {}})) == jax_rssm_scan_spec(dotdict({"algo": {}})) == (1, 0)


def test_rssm_state_slab_matches_jax_and_keeps_tensors_on_their_device():
    rng = np.random.default_rng(8)
    rec, stoch = rng.normal(size=(3, REC)).astype(np.float32), rng.normal(size=(3, Z)).astype(np.float32)
    for valid in (True, False):
        got, want = rssm_state_slab(3, rec, stoch, valid), jax_rssm_state_slab(3, rec, stoch, valid)
        assert tuple(got) == tuple(want) == RSSM_STATE_KEYS
        for k in got:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    slab = rssm_state_slab(3, _t(rec), _t(stoch), True)
    assert isinstance(slab["rssm_recurrent"], torch.Tensor) and slab["rssm_recurrent"].shape == (1, 3, REC)
    with pytest.raises(ValueError, match="num_envs=2"):
        rssm_state_slab(2, rec, stoch, True)
