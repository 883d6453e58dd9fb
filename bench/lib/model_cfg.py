"""The program's model configuration for a benchmark configuration file,
held to the published numbers the file states."""
from __future__ import annotations

# published key -> the program's ModelConfig field (numbers compared)
SAME = (("hidden_size", "d_model"), ("num_hidden_layers", "num_layers"),
        ("num_attention_heads", "num_heads"), ("vocab_size", "vocab_size"),
        ("rope_theta", "rope_theta"))
DENSE = (("num_key_value_heads", "num_kv_heads"),
         ("intermediate_size", "d_ff"), ("sliding_window", "window_size"))
MOE = (("kv_lora_rank", "kv_lora_rank"), ("q_lora_rank", "q_lora_rank"),
       ("qk_rope_head_dim", "rope_head_dim"),
       ("qk_nope_head_dim", "head_dim"), ("v_head_dim", "head_dim"),
       ("n_routed_experts", "num_experts"),
       ("num_experts_per_tok", "experts_per_token"),
       ("n_shared_experts", "num_shared_experts"),
       ("moe_intermediate_size", "moe_d_ff"),
       ("intermediate_size", "d_ff"))


def pairs(pub: dict):
    return SAME + (MOE if pub.get("n_routed_experts") else DENSE)


def check_matches(pub: dict, mcfg) -> None:
    """Raise unless the program's config has the file's numbers."""
    bad = [(k, pub[k], getattr(mcfg, f)) for k, f in pairs(pub)
           if k in pub and pub[k] != getattr(mcfg, f)
           and not (pub[k] is not None and getattr(mcfg, f) is not None
                    and float(pub[k]) == float(getattr(mcfg, f)))]
    if bad:
        raise ValueError(f"{mcfg.name}: the program's config differs from "
                         f"the benchmark's file: {bad}")


def program_config(conf: dict, smoke: bool = False):
    """The program's ModelConfig for the configuration file `conf`, set as
    the file's `program` section says: `arch` names the program's config;
    `dropless_moe` sets the MoE capacity so no routed token is dropped."""
    from repro_torch.models.registry import get_config
    prog = conf["bench"]["program"]
    mcfg = get_config(prog["arch"], smoke=smoke)
    if not smoke:
        check_matches(conf, mcfg)
    if prog.get("dropless_moe") and mcfg.num_experts:
        mcfg = mcfg.with_(moe_capacity_factor=float(
            mcfg.num_experts) / mcfg.experts_per_token)
    return mcfg


def published(conf: dict, mcfg, smoke: bool = False) -> dict:
    """The published keys the reference reads; at `smoke` sizes (tests on
    the CPU) the numbers come from the program's small config."""
    pub = {k: v for k, v in conf.items() if k != "bench"}
    if smoke:
        for k, f in pairs(pub):
            if k in pub:
                pub[k] = getattr(mcfg, f)
        if pub.get("sliding_window") is not None:
            pub["sliding_window"] = mcfg.window_size
    return pub
