"""A Jamba training step's model flops, from the configuration and the
rows the held experts computed.

Forward flops a token (2 a multiply-add): a Mamba layer's in, x, dt and
out projections (2 * (d * 2 di + di * (r + 2 ds) + r * di + di * d)), its
depthwise conv (2 * K * di) and its selective scan, 7 * di * ds (the
discretisation exp(delta A) and delta B u, 3; the state update, 2; the
readout h . C, 2); the attention layer's projections
(2 * d * (2 H Dh + 2 KV Dh)) and, causal, its scores and values
(4 * H * Dh * (S + 1) / 2 a token on average); a dense SwiGLU
(6 * d * f); an MoE layer's router (2 * d * E) and, for each entry a held
expert computed, 6 * d * f; the unembedding (2 * d * V). A training step is
three forwards' worth (the forward, and the backward's two products a
product); remat's recompute is not counted, nor the norms and the
element-wise gates."""


def _layer_kinds(c):
    out = []
    for i in range(c["num_hidden_layers"]):
        mixer = "attention" if i % c["attn_layer_period"] == c["attn_layer_offset"] else "mamba"
        ffn = "moe" if i % c["expert_layer_period"] == c["expert_layer_offset"] else "dense"
        out.append((mixer, ffn))
    return out


def forward_flops(c, seq: int, batch: int, router_experts: int, moe_rows: float) -> float:
    """One forward's model flops: ``c`` the JambaConfig keys, ``moe_rows``
    the entries the held experts computed, summed over the MoE layers."""
    d, f, V = c["hidden_size"], c["intermediate_size"], c["vocab_size"]
    di, ds = c["mamba_expand"] * d, c["mamba_d_state"]
    r, K = c["mamba_dt_rank"], c["mamba_d_conv"]
    H, KV = c["num_attention_heads"], c["num_key_value_heads"]
    Dh = d // H
    T = seq * batch
    per_token = 2.0 * d * V
    for mixer, ffn in _layer_kinds(c):
        if mixer == "mamba":
            per_token += 2.0 * (d * 2 * di + di * (r + 2 * ds) + r * di + di * d)
            per_token += 2.0 * K * di + 7.0 * di * ds
        else:
            per_token += 2.0 * d * (2 * H * Dh + 2 * KV * Dh) + 4.0 * H * Dh * (seq + 1) / 2
        per_token += 2.0 * d * router_experts if ffn == "moe" else 6.0 * d * f
    return per_token * T + 6.0 * d * f * moe_rows


def step_flops(c, seq: int, batch: int, router_experts: int, moe_rows: float) -> float:
    return 3.0 * forward_flops(c, seq, batch, router_experts, moe_rows)
