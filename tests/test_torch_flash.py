"""Port parity: flash attention (kernel K2's plain version on the CPU)
against ``repro.models.layers.flash_attention`` and
``repro.kernels.flash_attn.flash_attention_ref``: causal, q_offset,
Sq != Sk, GQA groups, negative k_offset and ragged key chunks, f32,
rtol 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attn as jfa
from repro.models import layers as jl
from repro_torch.models import layers as tl

CASES = [
    # B, Sq, Sk, KV, G, dh, q_offset, k_offset, q_chunk, k_chunk
    (2, 16, 16, 2, 1, 8, 0, 0, 8, 8),        # plain causal, two tiles
    (1, 8, 24, 1, 3, 16, 16, 0, 8, 16),      # Sq != Sk, continuation, G=3
    (2, 12, 20, 2, 2, 8, 8, -4, 4, 8),       # prefix keys (k_offset < 0)
    (2, 63, 63, 2, 1, 16, 0, 0, 512, 2048),  # training shape S=63
    (1, 16, 21, 1, 2, 8, 5, 0, 16, 8),       # ragged key chunks
]


def _inputs(B, Sq, Sk, KV, G, dh, seed=0):
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, Sq, KV, G, dh)).astype(np.float32),
            r.standard_normal((B, Sk, KV, dh)).astype(np.float32),
            r.standard_normal((B, Sk, KV, dh)).astype(np.float32))


@pytest.mark.parametrize("case", CASES)
def test_flash_matches_reference_layers(case):
    B, Sq, Sk, KV, G, dh, qo, ko, qc, kc = case
    q, k, v = _inputs(B, Sq, Sk, KV, G, dh)
    want = np.asarray(jl.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        q_offset=qo, k_offset=ko, q_chunk=qc, k_chunk=kc))
    got = tl.flash_attention(torch.tensor(q), torch.tensor(k),
                             torch.tensor(v), causal=True, q_offset=qo,
                             k_offset=ko, q_chunk=qc, k_chunk=kc).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("Sq,Sk", [(32, 32), (16, 48)])
def test_flash_matches_reference_oracle(Sq, Sk):
    """Against the Pallas kernel's own oracle in its (BH, S, dh) layout
    (causal counted from position 0 of both sequences)."""
    q, k, v = _inputs(3, Sq, Sk, 1, 1, 16, seed=1)
    want = np.asarray(jfa.flash_attention_ref(
        jnp.asarray(q[:, :, 0, 0]), jnp.asarray(k[:, :, 0]),
        jnp.asarray(v[:, :, 0]), causal=True))
    got = tl.flash_attention(torch.tensor(q), torch.tensor(k),
                             torch.tensor(v), causal=True, q_chunk=8,
                             k_chunk=8).numpy()[:, :, 0, 0]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_flash_ragged_query_chunks_match_single_chunk():
    """Any q chunking gives the rows of one whole-sequence chunk."""
    q, k, v = (torch.tensor(a) for a in _inputs(2, 20, 20, 1, 2, 8, seed=2))
    one = tl.flash_attention(q, k, v, q_chunk=20, k_chunk=20)
    many = tl.flash_attention(q, k, v, q_chunk=6, k_chunk=20)
    torch.testing.assert_close(one, many, rtol=1e-6, atol=1e-6)
