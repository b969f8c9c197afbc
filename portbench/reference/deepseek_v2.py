"""DeepSeek-V2 (configuration ``deepseek-v2-lite``): the plain reference, its
seeded weights and prompts, and its operations and bytes.

An event is one prompt of ``prompt_tokens`` token ids (a (1, S) int64 row);
its output is the last position's logits, (1, vocab) float32, from which a
serving prefill samples the first token.

The forward pass follows the published modelling code
(``modeling_deepseek.py`` of https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite)
in float32, plain ``torch`` only, with no cache, no batching and no
kernel. Departures from the published model, each deliberate:

* precision: every product in float32 (the published model runs in bf16);
  the weights are the bf16 values the program holds, read as float32;
* the chip's share (8 chips share each layer): each MoE layer routes over
  all ``experts_routed_over`` experts but computes only the experts
  ``experts_held_from`` .. + ``n_routed_experts``; what the others would add
  is left out, and the shared experts are added once. The vocabulary is the
  slice held here (``vocab_size`` rows of the embedding, columns of the
  head), so the logits are over the slice;
* attention is computed a block of ``Q_BLOCK`` queries at a time against
  the keys up to the block's last (the causal mask hides the rest), so that
  it fits at S = 16,384; the published code forms the whole (S, S) score;
* the matrices are stored (in, out) and applied as x @ W (``nn.Linear``
  stores (out, in)); the function is the same.

Weights are random, from the seed (no checkpoint): fan-in scaled normal
matrices, normal embedding rows, unit norm scales. Nothing here imports the
program under test.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

Q_BLOCK = 512
E4M3_MAX = 448.0


# ---------------------------------------------------------------------------
# The configuration's sizes
# ---------------------------------------------------------------------------

def _dims(cfg):
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    return d, H, nope, rope, cfg["v_head_dim"], cfg["kv_lora_rank"]


def yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_inv_freq(cfg) -> torch.Tensor:
    """The published ``DeepseekV2YarnRotaryEmbedding``'s inverse
    frequencies, (rope/2,) float32."""
    y, dim, base = cfg["rope_scaling"], cfg["qk_rope_head_dim"], \
        cfg["rope_theta"]

    def corr_dim(rotations):
        return (dim * math.log(y["original_max_position_embeddings"]
                               / (rotations * 2 * math.pi))
                / (2 * math.log(base)))
    low = max(math.floor(corr_dim(y["beta_fast"])), 0)
    high = min(math.ceil(corr_dim(y["beta_slow"])), dim - 1)
    extra = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float32)
                           / dim)
    inter = extra / y["factor"]
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low)
            / (high - low if high > low else 0.001)).clamp(0, 1)
    mask = 1.0 - ramp
    return inter * (1 - mask) + extra * mask


def softmax_scale(cfg) -> float:
    """q_head_dim^-1/2 times yarn_mscale(factor, mscale_all_dim)^2."""
    y = cfg["rope_scaling"]
    m = yarn_mscale(y["factor"], y["mscale_all_dim"])
    return (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5 \
        * m * m


# ---------------------------------------------------------------------------
# The forward pass
# ---------------------------------------------------------------------------

def _same(t, rows=False):
    return t


def _mm(a, w, operand):
    return operand(a) @ operand(w.float())


def _rmsnorm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def _rope(x, positions, inv_freq, m):
    """The published ``apply_rotary_pos_emb`` on x (S, h, rope): the
    columns de-interleaved ((2i, 2i+1) become (i, i + rope/2)), then
    x·cos + rotate_half(x)·sin, with cos and sin of the positions times
    ``inv_freq`` (repeated), each times ``m``."""
    S, h, D = x.shape
    freqs = torch.outer(positions.float(), inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    cos, sin = emb.cos()[:, None] * m, emb.sin()[:, None] * m
    x = x.view(S, h, D // 2, 2).transpose(-1, -2).reshape(S, h, D)
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


def _attention(p, x, cfg, operand):
    """MLA without query LoRA, causal, over x (S, d) -> (S, d)."""
    d, H, nope, rope, vd, r = _dims(cfg)
    S = x.shape[0]
    eps = cfg["rms_norm_eps"]
    y = cfg["rope_scaling"]
    inv_freq = yarn_inv_freq(cfg).to(x.device)
    m = (yarn_mscale(y["factor"], y["mscale"])
         / yarn_mscale(y["factor"], y["mscale_all_dim"]))
    pos = torch.arange(S, device=x.device)
    q = _mm(x, p["q_proj"], operand).view(S, H, nope + rope)
    q_nope, q_pe = q[..., :nope], _rope(q[..., nope:], pos, inv_freq, m)
    ckv = _mm(x, p["kv_a_proj_with_mqa"], operand)
    c, k_pe = ckv[:, :r], _rope(ckv[:, None, r:], pos, inv_freq, m)
    kv = _mm(_rmsnorm(c, p["kv_a_layernorm"], eps), p["kv_b_proj"],
             operand).view(S, H, nope + vd)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    qh = torch.cat([q_nope, q_pe], dim=-1).transpose(0, 1)        # (H,S,qk)
    kh = torch.cat([k_nope, k_pe.expand(S, H, rope)],
                   dim=-1).transpose(0, 1)
    vh = v.transpose(0, 1)                                          # (H,S,v)
    scale = softmax_scale(cfg)
    out = torch.empty((S, H, vd), dtype=torch.float32, device=x.device)
    for s0 in range(0, S, Q_BLOCK):
        s1 = min(s0 + Q_BLOCK, S)
        sc = (operand(qh[:, s0:s1]) @ operand(kh[:, :s1]).transpose(1, 2)
              ) * scale
        hide = (torch.arange(s0, s1, device=x.device)[:, None]
                < torch.arange(s1, device=x.device)[None, :])
        w = torch.softmax(sc.masked_fill(hide, float("-inf")), dim=-1)
        out[s0:s1] = (operand(w, rows=True) @ operand(vh[:, :s1])
                      ).transpose(0, 1)
    return _mm(out.reshape(S, H * vd), p["o_proj"], operand)


def _swiglu(p, x, operand):
    return _mm(F.silu(_mm(x, p["gate_proj"], operand))
               * _mm(x, p["up_proj"], operand), p["down_proj"], operand)


def routing(p, x, cfg, operand=_same):
    """The published ``MoEGate`` (greedy top-k of a float32 softmax over
    every routed expert; the gates renormalised only with
    ``norm_topk_prob``, then times ``routed_scaling_factor``): (gates,
    expert ids), each (S, top_k)."""
    probs = torch.softmax(_mm(x, p["gate"], operand), dim=-1)
    gates, ids = torch.topk(probs, cfg["num_experts_per_tok"], dim=-1)
    if cfg["norm_topk_prob"]:
        gates = gates / gates.sum(dim=-1, keepdim=True)
    return gates * cfg["routed_scaling_factor"], ids


def _moe(p, x, cfg, operand, shared=True):
    """The held experts' part of the published ``DeepseekV2MoE`` on x
    (S, d): each held expert's SwiGLU on the rows routed to it, weighted by
    their gates, and (``shared``) the shared experts once."""
    gates, ids = routing(p, x, cfg, operand)
    out = torch.zeros_like(x)
    first = cfg["experts_held_from"]
    ex = p["experts"]
    for j in range(cfg["n_routed_experts"]):
        tok, slot = torch.nonzero(ids == first + j, as_tuple=True)
        if tok.numel():
            e = {k: ex[k][j] for k in ("gate_proj", "up_proj", "down_proj")}
            out.index_add_(0, tok, _swiglu(e, x[tok], operand)
                           * gates[tok, slot, None])
    if shared:
        out = out + _swiglu(p["shared_experts"], x, operand)
    return out


def _layer(p, x, cfg, i, operand):
    eps = cfg["rms_norm_eps"]
    x = x + _attention(p["self_attn"], _rmsnorm(x, p["input_layernorm"], eps),
                       cfg, operand)
    h = _rmsnorm(x, p["post_attention_layernorm"], eps)
    if i < cfg["first_k_dense_replace"]:
        return x + _swiglu(p["mlp"], h, operand)
    return x + _moe(p["mlp"], h, cfg, operand)


def logits(cfg, model, tokens: torch.Tensor, operand=_same,
           last: bool = True) -> torch.Tensor:
    """tokens (S,) int64 -> the logits (1, vocab) of the last position
    (``last``) or (S, vocab) of every position, float32."""
    x = model["embed_tokens"][tokens].float()
    for i, p in enumerate(model["layers"]):
        x = _layer(p, x, cfg, i, operand)
    if last:
        x = x[-1:]
    x = _rmsnorm(x, model["norm"], cfg["rms_norm_eps"])
    return _mm(x, model["lm_head"], operand)


def forward(cfg, model, x: torch.Tensor) -> torch.Tensor:
    """A (1, S) prompt -> its last position's logits (1, vocab) float32."""
    return logits(cfg, model, x[0])


def _e4m3(t: torch.Tensor, rows: bool = False) -> torch.Tensor:
    """t on the e4m3 grid as fp8 inference puts an operand there: scaled so
    that its largest magnitude, over the tensor or over each row along the
    last dimension (``rows``), is e4m3's largest, rounded, and scaled
    back."""
    a = t.abs()
    amax = a.amax(dim=-1, keepdim=True) if rows else a.amax()
    s = E4M3_MAX / amax.clamp_min(torch.finfo(torch.float32).tiny)
    return ((t * s).clamp(-E4M3_MAX, E4M3_MAX).to(torch.float8_e4m3fn)
            .to(torch.float32) / s)


def lower_precision(cfg, model):
    """The reference with every product's operands on the e4m3 grid
    (``_e4m3``): the projections, the router, the experts, the head and
    attention's two products (scores and the weighted sum of v), each
    operand scaled by its largest magnitude, the softmax weights row by
    row."""
    return lambda x: logits(cfg, model, x[0], operand=_e4m3)


# ---------------------------------------------------------------------------
# Seeded weights and prompts
# ---------------------------------------------------------------------------

def _matrix(gen, shape, device, scale=None):
    """A bf16 matrix of normal entries times 1/sqrt(fan-in), drawn f32."""
    scale = 1.0 / math.sqrt(shape[-2]) if scale is None else scale
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return w.mul_(scale).to(torch.bfloat16)


def _swiglu_weights(gen, d, f, device):
    return {"gate_proj": _matrix(gen, (d, f), device),
            "up_proj": _matrix(gen, (d, f), device),
            "down_proj": _matrix(gen, (f, d), device)}


def make_model(cfg, gen, device) -> dict:
    """The seeded weights, bf16 matrices (the router's bf16 values and the
    norm scales held in float32)."""
    d, H, nope, rope, vd, r = _dims(cfg)
    V, E = cfg["vocab_size"], cfg["experts_routed_over"]
    n, f = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    ones = lambda k: torch.ones(k, dtype=torch.float32, device=device)
    layers = []
    for i in range(cfg["num_hidden_layers"]):
        attn = {"q_proj": _matrix(gen, (d, H * (nope + rope)), device),
                "kv_a_proj_with_mqa": _matrix(gen, (d, r + rope), device),
                "kv_a_layernorm": ones(r),
                "kv_b_proj": _matrix(gen, (r, H * (nope + vd)), device),
                "o_proj": _matrix(gen, (H * vd, d), device)}
        if i < cfg["first_k_dense_replace"]:
            mlp = _swiglu_weights(gen, d, cfg["intermediate_size"], device)
        else:
            experts = [_swiglu_weights(gen, d, f, device) for _ in range(n)]
            mlp = {"gate": _matrix(gen, (d, E), device).float(),
                   "experts": {k: torch.stack([e[k] for e in experts])
                               for k in experts[0]},
                   "shared_experts": _swiglu_weights(
                       gen, d, cfg["n_shared_experts"] * f, device)}
        layers.append({"input_layernorm": ones(d), "self_attn": attn,
                       "post_attention_layernorm": ones(d), "mlp": mlp})
    return {"embed_tokens": _matrix(gen, (V, d), device, scale=1.0),
            "layers": layers, "norm": ones(d),
            "lm_head": _matrix(gen, (d, V), device)}


def prompts(cfg, traffic, gen, device) -> list:
    """``pool_batches`` batches of ``batch_events`` prompts of
    ``prompt_tokens`` ids, drawn i.i.d. from a Zipf law of exponent
    ``zipf_exponent`` over the vocabulary held, the map from rank to id a
    permutation drawn from the same generator."""
    V = cfg["vocab_size"]
    rank = torch.arange(1, V + 1, dtype=torch.float32, device=device)
    p = rank.pow(-traffic["zipf_exponent"])
    ids = torch.randperm(V, generator=gen, device=device)
    n = traffic["batch_events"] * traffic["prompt_tokens"]
    return [ids[torch.multinomial(p, n, replacement=True, generator=gen)]
            .view(traffic["batch_events"], traffic["prompt_tokens"])
            for _ in range(traffic["pool_batches"])]


def make_inputs(cfg, traffic, seed: int, device):
    """(model, pool) from ``seed``: the weights (``make_model``), then the
    prompts (``prompts``). The traffic's prompt length must be the
    configuration's, which its counts use."""
    if traffic["prompt_tokens"] != cfg["prompt_tokens"]:
        raise ValueError(f"the traffic's {traffic['prompt_tokens']}-token "
                         f"prompts are not the configuration's "
                         f"{cfg['prompt_tokens']}")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    model = make_model(cfg, gen, device)
    return model, prompts(cfg, traffic, gen, device)


def events_in(cfg, x: torch.Tensor) -> int:
    return x.shape[0]


# ---------------------------------------------------------------------------
# Operations and bytes, at the configuration's widths
# ---------------------------------------------------------------------------

def visible_pairs(S: int) -> int:
    """(query, key) pairs the causal mask shows in a prompt of S tokens."""
    return S * (S + 1) // 2


def k5_launch_ops(cfg) -> int:
    """One K5 launch (a layer's attention over a prompt): 2·(qk + v)
    operations a visible pair a head, at qk = nope + rope and v as
    published (the kernel's padding of v is not counted)."""
    d, H, nope, rope, vd, r = _dims(cfg)
    return 2 * H * (nope + rope + vd) * visible_pairs(cfg["prompt_tokens"])


def k5_launch_bytes(cfg) -> int:
    """One K5 launch: q, k (qk wide) and v read once, o (v wide) written
    once, bf16, every head."""
    d, H, nope, rope, vd, r = _dims(cfg)
    return 2 * cfg["prompt_tokens"] * H * (2 * (nope + rope) + 2 * vd)


def _per_token_macs(cfg) -> dict:
    """Multiply-adds a token, by part, at the published widths; a MoE
    layer's routed experts at their expected rows: top_k · held / routed
    over of the tokens an expert."""
    d, H, nope, rope, vd, r = _dims(cfg)
    f, E = cfg["moe_intermediate_size"], cfg["experts_routed_over"]
    n_dense = cfg["first_k_dense_replace"]
    n_moe = cfg["num_hidden_layers"] - n_dense
    mla = (d * H * (nope + rope) + d * (r + rope) + r * H * (nope + vd)
           + H * vd * d)
    expert = 3 * d * f
    return {
        "mla": cfg["num_hidden_layers"] * mla,
        "dense": n_dense * 3 * d * cfg["intermediate_size"],
        "moe": n_moe * (d * E + cfg["n_shared_experts"] * expert
                        + expert * cfg["num_experts_per_tok"]
                        * cfg["n_routed_experts"] / E),
    }


def ops_per_event(cfg) -> float:
    """The operations one prompt needs: 2 a multiply-add of the projections
    and the (expected) MoE work for every token, K5's visible pairs in every
    layer, and the head on the last position only."""
    S = cfg["prompt_tokens"]
    per_token = sum(_per_token_macs(cfg).values())
    head = cfg["hidden_size"] * cfg["vocab_size"]
    return (2 * S * per_token + 2 * head
            + cfg["num_hidden_layers"] * k5_launch_ops(cfg))


def bytes_per_event(cfg) -> int:
    """The prompt's int64 ids read once and its float32 logits written
    once."""
    return 8 * cfg["prompt_tokens"] + 4 * cfg["vocab_size"]


def weight_bytes(cfg) -> int:
    """The weights read once a prompt: bf16 matrices, float32 router and
    norm scales."""
    d, H, nope, rope, vd, r = _dims(cfg)
    f, E, n = (cfg["moe_intermediate_size"], cfg["experts_routed_over"],
               cfg["n_routed_experts"])
    L, n_dense = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    mla = (d * H * (nope + rope) + d * (r + rope) + r * H * (nope + vd)
           + H * vd * d)
    bf16 = (L * mla + n_dense * 3 * d * cfg["intermediate_size"]
            + (L - n_dense) * (n + cfg["n_shared_experts"]) * 3 * d * f
            + 2 * cfg["vocab_size"] * d)
    f32 = L * (2 * d + r) + d + (L - n_dense) * d * E
    return 2 * bf16 + 4 * f32
