"""T5 and CLIP text encoders as PyTorch modules: FLUX conditioning.

Port of ``skyfall_gs_tpu/priors/text_encoders.py``.  The FLUX pipeline the
reference's FlowEdit refiner wraps conditions the DiT on two text encoders:

  * T5-XXL (``text_encoder_2``): the (L, 4096) token sequence fed to the
    joint-attention context stream;
  * CLIP-L (``text_encoder``): the (768,) pooled embedding mixed into the
    AdaLN conditioning vector.

The modules' ``state_dict`` keys are transformers' ``T5EncoderModel`` and
``CLIPTextModel`` names, so ``convert_t5_state_dict`` /
``convert_clip_text_state_dict`` only pick (and check) the keys of a local
checkpoint, and ``t5_state_from_numpy`` / ``clip_text_state_from_numpy``
carry the JAX package's parameter pytrees across.  ``init_t5`` draws
random weights at T5's own init scales, ``init_clip_text`` as the JAX
package's init does.
Tokenization is the caller's concern: the encoders take token ids (the
tokenizers' vocabularies are not in the repository).

Precision: the modules compute in their parameters' dtype (bf16 on the
card, fp32 in the parity tests).  Norm statistics, attention scores and
their softmax are float32; the softmax weights multiply the values in the
parameter dtype, as the JAX package's ``preferred_element_type=f32``
einsums and FLUX's attention do.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from skyfall_gs_tpu_torch.priors.flux import build_module


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
            scale: float = 1.0) -> torch.Tensor:
    """(B, H, L, hd) each and an additive (.., L, L) float32 bias ->
    (B, L, H * hd): float32 scores and softmax, weights times values in
    ``v``'s dtype."""
    b, h, n, hd = q.shape
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale + bias
    out = torch.matmul(torch.softmax(s, -1).to(v.dtype), v)
    return out.transpose(1, 2).reshape(b, n, h * hd)


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, n, d = x.shape
    return x.reshape(b, n, heads, d // heads).transpose(1, 2)


# ----------------------------------------------------------------------------
# T5 encoder (v1.1 topology: RMSNorm, gated-GELU FF, relative position bias)
# ----------------------------------------------------------------------------

class T5Config(NamedTuple):
    vocab: int = 32_128
    d_model: int = 4096
    d_ff: int = 10_240
    heads: int = 64
    layers: int = 24
    rel_buckets: int = 32
    rel_max_dist: int = 128

    @classmethod
    def tiny(cls):
        return cls(vocab=128, d_model=32, d_ff=64, heads=2, layers=2,
                   rel_buckets=8, rel_max_dist=16)


class _RMSNorm(nn.Module):
    """T5 LayerNorm: no mean subtracted, no bias, float32 statistics."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        x32 = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + self.eps)
        return x32.to(x.dtype) * self.weight


class _T5SelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        d = cfg.d_model
        self.q, self.k, self.v, self.o = (nn.Linear(d, d, bias=False) for _ in range(4))
        if has_bias:
            self.relative_attention_bias = nn.Embedding(cfg.rel_buckets, cfg.heads)


class _T5AttnLayer(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        self.SelfAttention = _T5SelfAttention(cfg, has_bias)
        self.layer_norm = _RMSNorm(cfg.d_model)


class _T5DenseGated(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)


class _T5FFLayer(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = _T5DenseGated(cfg)
        self.layer_norm = _RMSNorm(cfg.d_model)


class _T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        self.layer = nn.ModuleList([_T5AttnLayer(cfg, has_bias), _T5FFLayer(cfg)])

    def forward(self, x: torch.Tensor, bias: torch.Tensor, heads: int) -> torch.Tensor:
        attn, ff = self.layer
        sa = attn.SelfAttention
        h = attn.layer_norm(x)
        # T5 omits the 1/sqrt(d) attention scaling (folded into its init).
        x = x + sa.o(_attend(_heads(sa.q(h), heads), _heads(sa.k(h), heads),
                             _heads(sa.v(h), heads), bias))
        h = ff.layer_norm(x)
        dense = ff.DenseReluDense
        return x + dense.wo(F.gelu(dense.wi_0(h), approximate="tanh") * dense.wi_1(h))


class _T5Stack(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.block = nn.ModuleList(_T5Block(cfg, i == 0) for i in range(cfg.layers))
        self.final_layer_norm = _RMSNorm(cfg.d_model)


def t5_rel_buckets(rel_pos: torch.Tensor, num_buckets: int, max_dist: int) -> torch.Tensor:
    """Bidirectional T5 relative position bucketing of ``key - query``."""
    nb = num_buckets // 2
    out = torch.where(rel_pos > 0, nb, 0)
    n = rel_pos.abs()
    max_exact = nb // 2
    large = max_exact + (torch.log(n.float() / max_exact + 1e-9)
                         / math.log(max_dist / max_exact) * (nb - max_exact)).to(torch.int64)
    large = torch.clamp_max(large, nb - 1)
    return out + torch.where(n < max_exact, n, large)


class T5Encoder(nn.Module):
    """The T5 encoder: (B, L) token ids -> (B, L, d_model) features
    (transformers ``T5EncoderModel`` key names)."""

    def __init__(self, cfg: T5Config = T5Config()):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab, cfg.d_model)
        self.encoder = _T5Stack(cfg)

    @torch.no_grad()
    def forward(self, token_ids: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``attn_mask``: (B, L) bool, False at padding keys."""
        cfg = self.cfg
        dev = self.shared.weight.device
        token_ids = torch.as_tensor(token_ids, device=dev).long()
        length = token_ids.shape[1]
        x = self.shared(token_ids)
        pos = torch.arange(length, device=dev)
        buckets = t5_rel_buckets(pos[None, :] - pos[:, None], cfg.rel_buckets,
                                 cfg.rel_max_dist)
        rel = self.encoder.block[0].layer[0].SelfAttention.relative_attention_bias
        bias = rel(buckets).float().permute(2, 0, 1)[None]      # (1, H, L, L)
        if attn_mask is not None:
            mask = torch.as_tensor(attn_mask, device=dev).bool()
            bias = bias + torch.where(mask[:, None, None, :], 0.0, -1e9)
        for blk in self.encoder.block:
            x = blk(x, bias, cfg.heads)
        return self.encoder.final_layer_norm(x)


@torch.no_grad()
def init_t5(cfg: T5Config = T5Config(), dtype=torch.float32, device="cuda",
            seed: int = 0) -> T5Encoder:
    """A random ``T5Encoder`` at T5's own init scales (transformers'
    ``T5PreTrainedModel._init_weights``, factor 1): the embedding N(0, 1),
    q N(0, 1 / (d_model * d_kv)) (T5 folds the attention's 1/sqrt(d_kv)
    into it), k / v N(0, 1 / d_model), o N(0, 1 / (heads * d_kv)), wi
    N(0, 1 / d_model), wo N(0, 1 / d_ff), the relative bias N(0, 1 /
    d_model), the norm scales 1; allocated in ``dtype`` on ``device`` and
    drawn tensor by tensor from one seeded generator there.

    The JAX package's ``init_t5_params`` draws every matrix N(0, 0.02^2),
    a shape-test init: without T5's folded 1/sqrt(d_kv) its attention
    logits at d_model 4096 are so peaked that rounding the weights to bf16
    alone moves a 2-layer encoder's output past 3e-2 (chip_smoke.py phase
    8e prints it).  T5 is trained from the scales above."""
    model = build_module(T5Encoder, cfg, dtype=dtype, device=device, seed=None)
    d, kv = cfg.d_model, cfg.d_model // cfg.heads
    std = {"shared.weight": 1.0, "q.weight": (d * kv) ** -0.5, "k.weight": d ** -0.5,
           "v.weight": d ** -0.5, "o.weight": (cfg.heads * kv) ** -0.5,
           "wi_0.weight": d ** -0.5, "wi_1.weight": d ** -0.5, "wo.weight": cfg.d_ff ** -0.5,
           "relative_attention_bias.weight": d ** -0.5}
    gen = torch.Generator(device=model.shared.weight.device).manual_seed(seed)
    for name, p in model.named_parameters():
        if p.ndim == 1:
            p.fill_(1.0)
        else:
            p.normal_(0.0, std[name.split(".", name.count(".") - 1)[-1]], generator=gen)
    return model


def convert_t5_state_dict(state_dict: Dict[str, object],
                          cfg: T5Config = T5Config()) -> Dict[str, torch.Tensor]:
    """The ``T5Encoder`` state dict of an HF ``T5EncoderModel`` checkpoint
    (raises KeyError on a missing key: nothing is left random)."""
    sd = dict(state_dict)
    if "shared.weight" not in sd:
        sd["shared.weight"] = sd["encoder.embed_tokens.weight"]
    with torch.device("meta"):
        keys = T5Encoder(cfg).state_dict().keys()
    return {k: torch.as_tensor(sd[k]) for k in keys}


def t5_state_from_numpy(params, cfg: T5Config = T5Config()) -> Dict[str, torch.Tensor]:
    """The JAX package's T5 parameter pytree (numpy or jax arrays) as a
    ``T5Encoder`` state dict; its (in, out) matrices become (out, in)."""
    def t(x):
        return torch.from_numpy(np.array(x, np.float32))

    sd = {"shared.weight": t(params["embed"]),
          "encoder.final_layer_norm.weight": t(params["final_norm"]),
          "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight":
              t(params["rel_bias"])}
    for i, blk in enumerate(params["blocks"]):
        p = f"encoder.block.{i}.layer"
        sd[f"{p}.0.layer_norm.weight"] = t(blk["ln1"])
        sd[f"{p}.1.layer_norm.weight"] = t(blk["ln2"])
        for name in ("q", "k", "v", "o"):
            sd[f"{p}.0.SelfAttention.{name}.weight"] = t(np.asarray(blk[name]).T)
        for name, key in (("wi_0", "wi0"), ("wi_1", "wi1"), ("wo", "wo")):
            sd[f"{p}.1.DenseReluDense.{name}.weight"] = t(np.asarray(blk[key]).T)
    return sd


# ----------------------------------------------------------------------------
# CLIP text encoder (ViT-L/14 text tower; pooled output at the EOT token)
# ----------------------------------------------------------------------------

class CLIPTextConfig(NamedTuple):
    vocab: int = 49_408
    width: int = 768
    heads: int = 12
    layers: int = 12
    max_len: int = 77
    eos_id: int = 49_407

    @classmethod
    def tiny(cls):
        return cls(vocab=128, width=32, heads=2, layers=2, max_len=16, eos_id=127)


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """``ln`` with float32 statistics, in ``x``'s dtype."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(),
                        ln.eps).to(x.dtype)


class _CLIPAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (
            nn.Linear(d, d) for _ in range(4))


class _CLIPMLP(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.fc1 = nn.Linear(d, 4 * d)
        self.fc2 = nn.Linear(4 * d, d)


class _CLIPLayer(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.self_attn = _CLIPAttention(d)
        self.layer_norm1 = nn.LayerNorm(d)
        self.mlp = _CLIPMLP(d)
        self.layer_norm2 = nn.LayerNorm(d)

    def forward(self, x: torch.Tensor, causal: torch.Tensor, heads: int) -> torch.Tensor:
        a = self.self_attn
        h = _layer_norm(x, self.layer_norm1)
        o = _attend(_heads(a.q_proj(h), heads), _heads(a.k_proj(h), heads),
                    _heads(a.v_proj(h), heads), causal,
                    scale=1.0 / math.sqrt(x.shape[-1] // heads))
        x = x + a.out_proj(o)
        h = self.mlp.fc1(_layer_norm(x, self.layer_norm2))
        h = h * torch.sigmoid(1.702 * h)                       # CLIP quick_gelu
        return x + self.mlp.fc2(h)


class _CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab, cfg.width)
        self.position_embedding = nn.Embedding(cfg.max_len, cfg.width)


class _CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(_CLIPLayer(cfg.width) for _ in range(cfg.layers))


class _CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _CLIPEmbeddings(cfg)
        self.encoder = _CLIPEncoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.width)


class CLIPTextEncoder(nn.Module):
    """The CLIP text tower: (B, L) token ids -> ((B, L, width) hidden,
    (B, width) pooled at the first EOS token) (transformers
    ``CLIPTextModel`` key names)."""

    def __init__(self, cfg: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.cfg = cfg
        self.text_model = _CLIPTextTransformer(cfg)

    @torch.no_grad()
    def forward(self, token_ids: torch.Tensor):
        cfg, tm = self.cfg, self.text_model
        dev = tm.embeddings.token_embedding.weight.device
        token_ids = torch.as_tensor(token_ids, device=dev).long()
        b, length = token_ids.shape
        x = tm.embeddings.token_embedding(token_ids) + \
            tm.embeddings.position_embedding.weight[None, :length]
        pos = torch.arange(length, device=dev)
        causal = torch.where(pos[None, :] <= pos[:, None], 0.0, -1e9)
        for layer in tm.encoder.layers:
            x = layer(x, causal, cfg.heads)
        x = _layer_norm(x, tm.final_layer_norm)
        eot = torch.argmax((token_ids == cfg.eos_id).int(), dim=1)
        return x, x[torch.arange(b, device=dev), eot]


def init_clip_text(cfg: CLIPTextConfig = CLIPTextConfig(), dtype=torch.float32,
                   device="cuda", seed: int = 0) -> CLIPTextEncoder:
    """A random ``CLIPTextEncoder`` drawn as the JAX package's
    ``init_clip_text_params`` draws: every matrix (the embeddings too)
    N(0, 0.02^2), biases 0, norm scales 1."""
    return build_module(CLIPTextEncoder, cfg, dtype=dtype, device=device, seed=seed)


def convert_clip_text_state_dict(state_dict: Dict[str, object],
                                 cfg: CLIPTextConfig = CLIPTextConfig()
                                 ) -> Dict[str, torch.Tensor]:
    """The ``CLIPTextEncoder`` state dict of an HF ``CLIPTextModel``
    checkpoint (raises KeyError on a missing key)."""
    with torch.device("meta"):
        keys = CLIPTextEncoder(cfg).state_dict().keys()
    return {k: torch.as_tensor(state_dict[k]) for k in keys}


def clip_text_state_from_numpy(params, cfg: CLIPTextConfig = CLIPTextConfig()
                               ) -> Dict[str, torch.Tensor]:
    """The JAX package's CLIP text parameter pytree (numpy or jax arrays) as
    a ``CLIPTextEncoder`` state dict."""
    def t(x):
        return torch.from_numpy(np.array(x, np.float32))

    tm = "text_model"
    sd = {f"{tm}.embeddings.token_embedding.weight": t(params["token_embed"]),
          f"{tm}.embeddings.position_embedding.weight": t(params["pos_embed"]),
          f"{tm}.final_layer_norm.weight": t(params["final_ln"]["scale"]),
          f"{tm}.final_layer_norm.bias": t(params["final_ln"]["bias"])}
    for i, blk in enumerate(params["blocks"]):
        p = f"{tm}.encoder.layers.{i}"
        for name, key in (("self_attn.q_proj", "q"), ("self_attn.k_proj", "k"),
                          ("self_attn.v_proj", "v"), ("self_attn.out_proj", "out"),
                          ("mlp.fc1", "fc1"), ("mlp.fc2", "fc2")):
            sd[f"{p}.{name}.weight"] = t(np.asarray(blk[key]["w"]).T)
            sd[f"{p}.{name}.bias"] = t(blk[key]["b"])
        for name, key in (("layer_norm1", "ln1"), ("layer_norm2", "ln2")):
            sd[f"{p}.{name}.weight"] = t(blk[key]["scale"])
            sd[f"{p}.{name}.bias"] = t(blk[key]["bias"])
    return sd
