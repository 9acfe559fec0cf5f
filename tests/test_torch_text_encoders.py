"""Port parity: the T5 and CLIP text encoders (priors/text_encoders.py) and
``flux_refiner.encode_prompts`` against the JAX package and against
transformers' ``T5EncoderModel`` / ``CLIPTextModel``, at tiny widths on the
CPU in float32.

Weights reach the port two ways, and both are held: the JAX parameter
pytree through ``t5_state_from_numpy`` / ``clip_text_state_from_numpy``,
and a transformers state dict through ``convert_*_state_dict`` and
``load_state_dict(strict=True)``.

Tolerance: 1e-5 norm-relative for every output (float32, different
summation orders; the padded and two-EOS inputs included).  Against
transformers: atol 2e-5, rtol 1e-4 per element, the JAX package's own
oracle bounds (tests/test_torch_oracles.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skyfall_gs_tpu.priors import flux_refiner as jref
from skyfall_gs_tpu.priors import text_encoders as jte
from skyfall_gs_tpu_torch.priors import flux_refiner as tref
from skyfall_gs_tpu_torch.priors import text_encoders as tte

torch.set_num_threads(1)


def rel(a, b):
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def np_tree(params):
    return jax.tree.map(np.asarray, params)


def loaded(cls, cfg, sd):
    m = cls(cfg).eval()
    m.load_state_dict(sd, strict=True)
    return m


@pytest.fixture(scope="module")
def t5_pair():
    cfg = jte.T5Config.tiny()
    tcfg = tte.T5Config(**cfg._asdict())
    params = jte.init_t5_params(jax.random.PRNGKey(0), cfg)
    return cfg, params, loaded(tte.T5Encoder, tcfg, tte.t5_state_from_numpy(np_tree(params), tcfg))


@pytest.fixture(scope="module")
def clip_pair():
    cfg = jte.CLIPTextConfig.tiny()
    tcfg = tte.CLIPTextConfig(**cfg._asdict())
    params = jte.init_clip_text_params(jax.random.PRNGKey(1), cfg)
    return cfg, params, loaded(tte.CLIPTextEncoder, tcfg,
                               tte.clip_text_state_from_numpy(np_tree(params), tcfg))


def test_configs_are_the_published_widths():
    assert tte.T5Config() == tte.T5Config(vocab=32_128, d_model=4096, d_ff=10_240, heads=64,
                                          layers=24, rel_buckets=32, rel_max_dist=128)
    assert tuple(tte.T5Config()) == tuple(jte.T5Config())
    assert tuple(tte.CLIPTextConfig()) == tuple(jte.CLIPTextConfig())
    assert tte.CLIPTextConfig().width == 768 and tte.CLIPTextConfig().max_len == 77
    assert tte.CLIPTextConfig().eos_id == 49_407


def test_t5_matches_jax_with_and_without_padding(t5_pair):
    cfg, params, model = t5_pair
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab, (2, 40)).astype(np.int32)   # past rel_max_dist 16
    unmasked = jte.t5_encode(params, jnp.asarray(ids), cfg)
    got = model(torch.from_numpy(ids))
    assert got.dtype == torch.float32 and rel(got, unmasked) <= 1e-5, rel(got, unmasked)
    mask = np.ones((2, 40), bool)
    mask[0, 25:] = False
    mask[1, 7:] = False
    want = jte.t5_encode(params, jnp.asarray(ids), cfg, attn_mask=jnp.asarray(mask))
    got = model(torch.from_numpy(ids), attn_mask=torch.from_numpy(mask))
    assert rel(got, want) <= 1e-5, rel(got, want)
    assert rel(got, unmasked) > 1e-3            # the mask matters, far past the tolerance
    pos = np.arange(-40, 41)
    np.testing.assert_array_equal(
        tte.t5_rel_buckets(torch.from_numpy(pos), cfg.rel_buckets, cfg.rel_max_dist).numpy(),
        np.asarray(jte._t5_rel_buckets(jnp.asarray(pos), cfg.rel_buckets, cfg.rel_max_dist)))


def test_clip_matches_jax_pooled_at_first_eos(clip_pair):
    cfg, params, model = clip_pair
    rng = np.random.default_rng(1)
    ids = rng.integers(0, cfg.vocab - 2, (3, 12)).astype(np.int32)
    ids[0, 4] = ids[0, 9] = cfg.eos_id           # two EOS tokens: pooled at the first
    ids[1, 11] = cfg.eos_id
    hidden_j, pooled_j = jte.clip_text_encode(params, jnp.asarray(ids), cfg)
    hidden, pooled = model(torch.from_numpy(ids))
    assert rel(hidden, hidden_j) <= 1e-5 and rel(pooled, pooled_j) <= 1e-5
    torch.testing.assert_close(pooled[0], hidden[0, 4], rtol=0, atol=0)
    torch.testing.assert_close(pooled[2], hidden[2, 0], rtol=0, atol=0)   # no EOS


def test_init_draws_and_tiny_forwards():
    t5 = tte.init_t5(tte.T5Config.tiny(), device="cpu", seed=0)
    sa = t5.encoder.block[0].layer[0].SelfAttention
    for w, std in ((t5.shared.weight, 1.0), (sa.q.weight, (32 * 16) ** -0.5),
                   (sa.k.weight, 32 ** -0.5), (t5.encoder.block[1].layer[1].DenseReluDense
                                               .wo.weight, 64 ** -0.5)):
        assert float(w.std()) == pytest.approx(std, rel=0.15)
    out = t5(torch.tensor([[3, 5, 7, 0, 0]]))
    assert out.shape == (1, 5, 32) and bool(torch.isfinite(out).all())
    clip = tte.init_clip_text(tte.CLIPTextConfig.tiny(), device="cpu", seed=0)
    hidden, pooled = clip(torch.tensor([[5, 9, 127, 0, 0]]))
    assert hidden.shape == (1, 5, 32) and pooled.shape == (1, 32)
    torch.testing.assert_close(pooled[0], hidden[0, 2], rtol=0, atol=0)
    bf16 = tte.init_t5(tte.T5Config.tiny(), dtype=torch.bfloat16, device="cpu", seed=0)
    assert bf16(torch.tensor([[3, 5]])).dtype == torch.bfloat16


@pytest.fixture(scope="module")
def hf_t5():
    import transformers

    cfg = tte.T5Config.tiny()
    hf_cfg = transformers.T5Config(
        vocab_size=cfg.vocab, d_model=cfg.d_model, d_kv=cfg.d_model // cfg.heads,
        d_ff=cfg.d_ff, num_layers=cfg.layers, num_heads=cfg.heads,
        relative_attention_num_buckets=cfg.rel_buckets,
        relative_attention_max_distance=cfg.rel_max_dist, feed_forward_proj="gated-gelu",
        dropout_rate=0.0, is_encoder_decoder=False, use_cache=False)
    torch.manual_seed(0)
    hf = transformers.T5EncoderModel(hf_cfg).eval()
    return cfg, hf, loaded(tte.T5Encoder, cfg, tte.convert_t5_state_dict(hf.state_dict(), cfg))


def test_t5_converter_matches_transformers(hf_t5):
    cfg, hf, model = hf_t5
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 9)))
    mask = torch.ones((2, 9), dtype=torch.long)
    mask[0, 5:] = 0
    mask[1, 3:] = 0
    with torch.no_grad():
        want = hf(input_ids=ids).last_hidden_state
        want_m = hf(input_ids=ids, attention_mask=mask).last_hidden_state
    torch.testing.assert_close(model(ids), want, atol=2e-5, rtol=1e-4)
    got_m = model(ids, attn_mask=mask.bool())
    for b in range(2):          # masked positions' outputs are unspecified
        n = int(mask[b].sum())
        torch.testing.assert_close(got_m[b, :n], want_m[b, :n], atol=2e-5, rtol=1e-4)
    # the tied embedding's other name, and a missing key
    sd = {("encoder.embed_tokens.weight" if k == "shared.weight" else k): v
          for k, v in hf.state_dict().items()}
    assert torch.equal(tte.convert_t5_state_dict(sd, cfg)["shared.weight"],
                       hf.shared.weight)
    del sd["encoder.final_layer_norm.weight"]
    with pytest.raises(KeyError):
        tte.convert_t5_state_dict(sd, cfg)


def test_clip_converter_matches_transformers():
    import transformers

    cfg = tte.CLIPTextConfig.tiny()
    hf_cfg = transformers.CLIPTextConfig(
        vocab_size=cfg.vocab, hidden_size=cfg.width, intermediate_size=4 * cfg.width,
        num_hidden_layers=cfg.layers, num_attention_heads=cfg.heads,
        max_position_embeddings=cfg.max_len, hidden_act="quick_gelu", eos_token_id=cfg.eos_id,
        bos_token_id=cfg.eos_id - 1, pad_token_id=None, attention_dropout=0.0)
    torch.manual_seed(0)
    hf = transformers.CLIPTextModel(hf_cfg).eval()
    model = loaded(tte.CLIPTextEncoder, cfg,
                   tte.convert_clip_text_state_dict(hf.state_dict(), cfg))
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab - 2, (2, 11))
    ids[0, 6] = cfg.eos_id
    ids[0, 8] = cfg.eos_id
    ids[1, 10] = cfg.eos_id
    ids = torch.from_numpy(ids)
    with torch.no_grad():
        out = hf(input_ids=ids)
    hidden, pooled = model(ids)
    torch.testing.assert_close(hidden, out.last_hidden_state, atol=2e-5, rtol=1e-4)
    torch.testing.assert_close(pooled, out.pooler_output, atol=2e-5, rtol=1e-4)


def test_converters_hold_a_jax_converted_checkpoint(hf_t5):
    """One transformers state dict through both packages' converters."""
    cfg, hf, model = hf_t5
    params = jte.convert_t5_state_dict({k: v.numpy() for k, v in hf.state_dict().items()},
                                       jte.T5Config.tiny())
    carried = tte.t5_state_from_numpy(np_tree(params), cfg)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(carried[k], v, rtol=0, atol=0)


def test_encode_prompts_matches_jax(t5_pair, clip_pair):
    t5_cfg, t5_params, t5 = t5_pair
    clip_cfg, clip_params, clip = clip_pair
    rng = np.random.default_rng(2)
    src_t5, tar_t5 = (rng.integers(0, t5_cfg.vocab, (1, 20)).astype(np.int32)
                      for _ in range(2))
    src_clip, tar_clip = (rng.integers(0, clip_cfg.vocab - 1, (1, clip_cfg.max_len))
                          .astype(np.int32) for _ in range(2))
    src_clip[0, 5] = src_clip[0, 9] = clip_cfg.eos_id
    tar_clip[0, 12] = clip_cfg.eos_id
    want = jref.encode_prompts(src_t5, tar_t5, src_clip, tar_clip, t5_params, clip_params,
                               t5_cfg, clip_cfg, guidance_src=2.0, guidance_tar=4.5)
    got = tref.encode_prompts(*(torch.from_numpy(x) for x in (src_t5, tar_t5, src_clip,
                                                               tar_clip)),
                              t5, clip, guidance_src=2.0, guidance_tar=4.5)
    for g, w in zip(got, want):
        assert g.txt.shape == (1, 20, t5_cfg.d_model) and g.pooled.shape == (1, clip_cfg.width)
        assert rel(g.txt, w.txt) <= 1e-5 and rel(g.pooled, w.pooled) <= 1e-5
        assert g.guidance == w.guidance
