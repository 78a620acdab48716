"""Port parity of beam search: the port's ``BeamSearcher`` against the JAX
package's on the same spec, converted weights and prompt, for beam sizes
1, 2 and 4, with and without an eos id (the over-sampling path: the eos
id is a token the 4-beam search emits second, so hypotheses exit at the
first decode step and the winner is one of them).  Float32 on the CPU, the port on its plain kernels:
tokens identical and the length-normalised score within 1e-5.  Beam size
1 must equal the port's greedy decode.  Each JAX searcher is built once
per beam size (it compiles its decode per batch size).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import build_model as jax_build_model
from repro.serving.beam import BeamSearcher as JaxBeamSearcher
from repro_torch.configs import registry as treg
from repro_torch.models import build_model, from_jax_params
from repro_torch.serving import BeamSearcher

ARCH = "minitron-8b"  # reduced: 2 layers, GQA 8/2, d_head 16, vocab 512
PROMPT = [5, 9, 2, 17, 33, 4, 101, 7]
MAX_NEW = 6
MAX_SEQ = 32
SCORE_ATOL = 1e-5


@functools.lru_cache(maxsize=None)
def _models():
    jspec, tspec = jreg.get_reduced(ARCH), treg.get_reduced(ARCH)
    jmodel = jax_build_model(jspec, mesh=None, param_dtype=jnp.float32,
                             compute_dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.key(11)))
    tmodel = build_model(tspec, device="cpu", dtype=torch.float32)
    tmodel.load_state_dict(from_jax_params(tree, tspec))
    return jmodel, jax.tree.map(jnp.asarray, tree), tmodel


@functools.lru_cache(maxsize=None)
def _jax_searcher(sb):
    jmodel, params, _ = _models()
    return JaxBeamSearcher(jmodel, params, beam_size=sb, max_seq=MAX_SEQ)


@functools.lru_cache(maxsize=None)
def _eos():
    """An eos id the model emits early on a hypothesis: the second token
    of the JAX search's 4-beam result without eos."""
    return _jax_searcher(4).search(list(PROMPT), MAX_NEW)[0][1]


@pytest.mark.parametrize("with_eos", [False, True], ids=["no_eos", "eos"])
@pytest.mark.parametrize("sb", [1, 2, 4])
def test_beam_search_matches_jax(sb, with_eos):
    eos = _eos() if with_eos else None
    want_seq, want_score = _jax_searcher(sb).search(list(PROMPT), MAX_NEW,
                                                    eos_id=eos)
    searcher = BeamSearcher(_models()[2], beam_size=sb, max_seq=MAX_SEQ)
    got_seq, got_score = searcher.search(list(PROMPT), MAX_NEW, eos_id=eos)
    assert got_seq == want_seq
    np.testing.assert_allclose(got_score, want_score, rtol=0,
                               atol=SCORE_ATOL)


def test_beam_size_one_is_greedy():
    model = _models()[2]
    cache = model.init_cache(1, MAX_SEQ, layout="dense")
    logits, cache = model.prefill_chunk(cache, torch.tensor([PROMPT]))
    greedy = [int(logits[0].argmax())]
    for _ in range(MAX_NEW - 1):
        logits, cache = model.decode_step(cache, torch.tensor([[greedy[-1]]]))
        greedy.append(int(logits[0].argmax()))
    got, _ = BeamSearcher(model, beam_size=1,
                          max_seq=MAX_SEQ).search(list(PROMPT), MAX_NEW)
    assert got == greedy
