"""DeepSeek-V2 through the port: the reference's weights in the port's
``Transformer`` (the same tensors, no copy), run by ``steps.make_prefill``
with the last position's logits only: MLA through K5 at qk 192 (v padded),
the held experts' SwiGLUs, the untied head on one position."""
from __future__ import annotations

import dataclasses


#: What the port's DeepSeek-V2 holds fixed, as the published model has it.
FIXED = {"norm_topk_prob": False, "routed_scaling_factor": 1,
         "tie_word_embeddings": False, "scoring_func": "softmax",
         "topk_method": "greedy"}


def arch(cfg):
    """The port's ``DeepSeekV2Config`` for the configuration's file: the
    registry's ``deepseek-v2-lite`` with the file's sizes. Raises where the
    file asks for what the port holds fixed otherwise (``FIXED``)."""
    from repro_torch import configs
    from repro_torch.configs.base import MLAParams
    from repro_torch.configs.yarn import YaRN
    other = {k: cfg[k] for k, v in FIXED.items() if cfg[k] != v}
    if other:
        raise ValueError(f"the port's DeepSeek-V2 holds {FIXED}; the "
                         f"configuration asks for {other}")
    y = cfg["rope_scaling"]
    return dataclasses.replace(
        configs.get("deepseek-v2-lite"),
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"], n_kv=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
        pattern_head=("mla",) * cfg["first_k_dense_replace"],
        mla=MLAParams(q_lora_rank=cfg["q_lora_rank"],
                      kv_lora_rank=cfg["kv_lora_rank"],
                      qk_nope_dim=cfg["qk_nope_head_dim"],
                      qk_rope_dim=cfg["qk_rope_head_dim"],
                      v_head_dim=cfg["v_head_dim"]),
        rope_theta=float(cfg["rope_theta"]),
        yarn=YaRN(factor=float(y["factor"]),
                  original_max_position=y["original_max_position_embeddings"],
                  beta_fast=float(y["beta_fast"]),
                  beta_slow=float(y["beta_slow"]), mscale=y["mscale"],
                  mscale_all_dim=y["mscale_all_dim"]),
        n_experts=cfg["experts_routed_over"],
        top_k=cfg["num_experts_per_tok"],
        expert_ff=cfg["moe_intermediate_size"],
        n_shared_experts=cfg["n_shared_experts"],
        experts_held=(cfg["experts_held_from"], cfg["n_routed_experts"]))


def _swiglu(p):
    return {"wg": p["gate_proj"], "wu": p["up_proj"], "wd": p["down_proj"]}


def params(cfg, model) -> dict:
    """The reference's tree in the port's layout, the tensors themselves."""
    layers = []
    for i, p in enumerate(model["layers"]):
        a, m = p["self_attn"], p["mlp"]
        block = {"ln1": {"scale": p["input_layernorm"]},
                 "mla": {"wq": {"w": a["q_proj"]},
                         "wkv_a": {"w": a["kv_a_proj_with_mqa"]},
                         "kv_norm": {"scale": a["kv_a_layernorm"]},
                         "wkv_b": {"w": a["kv_b_proj"]},
                         "wo": {"w": a["o_proj"]}},
                 "ln2": {"scale": p["post_attention_layernorm"]}}
        if i < cfg["first_k_dense_replace"]:
            block["mlp"] = _swiglu(m)
        else:
            block["moe"] = {"router": m["gate"], **_swiglu(m["experts"]),
                            "shared": _swiglu(m["shared_experts"])}
        layers.append(block)
    return {"embedding": {"emb": model["embed_tokens"]},
            "final_norm": {"scale": model["norm"]},
            "lm_head": {"w": model["lm_head"]}, "layers": layers}


def build(cfg, model):
    from repro_torch.distributed.steps import make_prefill
    from repro_torch.models.transformer import Transformer
    a = arch(cfg)
    port = Transformer(a, params(cfg, model))
    prefill = make_prefill(a, device=port.device, last_only=True)

    def forward(x):
        return prefill(port, {"tokens": x})[:, 0]
    return forward
