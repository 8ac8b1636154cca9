"""Model configuration for the llama-family decoder architectures.

A framework-free copy of `eetq_tpu/models/config.py` (the port imports
nothing from `eetq_tpu`, whose package import pulls in JAX). One
parameterized architecture covers every preset; per-model differences are
data, not code. `ModelConfig.from_hf_config` reads a HuggingFace config.json
dict (llama-family keys, or chatglm2/3's own).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    max_position: int = 4096
    rope_theta: float = 10000.0
    rope_dim: int | None = None  # defaults to head_dim
    rms_eps: float = 1e-5
    activation: str = "silu"
    sliding_window: int | None = None  # mistral
    tie_word_embeddings: bool = False  # gemma, tinyllama-chat variants
    embedding_multiplier: float | None = None  # gemma: sqrt(hidden_size)
    rmsnorm_unit_offset: bool = False  # gemma: gamma = 1 + w
    qkv_bias: bool = False
    alibi: bool = False  # baichuan-13b: ALiBi position bias, no RoPE
    # chatglm2/3: GPT-J-style adjacent-lane rotary pairing over the first
    # half of head_dim (rope_dim = head_dim // 2)
    rope_interleaved: bool = False
    # mixtral: routed MoE MLP (num_local_experts / num_experts_per_tok in
    # the HF config); None = dense MLP
    num_experts: int | None = None
    num_experts_per_tok: int = 2
    model_type: str = "llama"

    @property
    def rot_dim(self) -> int:
        return self.rope_dim or self.head_dim

    @property
    def qkv_out(self) -> int:
        return (self.num_heads + 2 * self.num_kv_heads) * self.head_dim

    @classmethod
    def from_hf_config(cls, hf: dict) -> "ModelConfig":
        """Build from a HuggingFace config.json dict (llama/mistral/gemma/
        baichuan/tinyllama)."""
        model_type = hf.get("model_type", "llama")
        if model_type.startswith("chatglm"):
            return cls._from_chatglm_config(hf)
        num_heads = hf["num_attention_heads"]
        num_kv = hf.get("num_key_value_heads", num_heads)
        head_dim = hf.get("head_dim") or hf["hidden_size"] // num_heads
        act = hf.get("hidden_act", "silu")
        if act in ("gelu_pytorch_tanh", "gelu_new", "gelu_fast"):
            act = "gelu"
        return cls(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=num_heads,
            num_kv_heads=num_kv,
            head_dim=head_dim,
            max_position=hf.get("max_position_embeddings", 4096),
            rope_theta=hf.get("rope_theta", 10000.0),
            rms_eps=hf.get("rms_norm_eps", 1e-5),
            activation=act,
            sliding_window=hf.get("sliding_window"),
            # transformers' GemmaConfig defaults tie_word_embeddings=True
            # and save_pretrained OMITS class-default keys from config.json
            # — so absence means TIED for gemma, untied for llama-family
            tie_word_embeddings=hf.get(
                "tie_word_embeddings", model_type == "gemma"
            ),
            embedding_multiplier=(
                hf["hidden_size"] ** 0.5 if model_type == "gemma" else None
            ),
            rmsnorm_unit_offset=model_type == "gemma",
            # qwen2 always uses q/k/v biases; llama-family configs may opt
            # in via attention_bias
            qkv_bias=model_type == "qwen2" or hf.get("attention_bias", False),
            # Baichuan configs carry no position-embedding field; the 13B
            # (40 heads / hidden 5120) uses ALiBi, the 7B RoPE — same
            # detection the community loaders use. Explicit "alibi": true
            # or "position_embedding": "ALIBI" (baichuan2) also honored.
            alibi=bool(
                hf.get("alibi", False)
                or str(hf.get("position_embedding", "")).upper() == "ALIBI"
                or (model_type == "baichuan" and num_heads >= 40)
            ),
            num_experts=hf.get("num_local_experts"),
            num_experts_per_tok=hf.get("num_experts_per_tok", 2),
            model_type=model_type,
        )

    @classmethod
    def _from_chatglm_config(cls, hf: dict) -> "ModelConfig":
        """ChatGLM2/3 configs use their own key names (num_layers,
        padded_vocab_size, ffn_hidden_size, kv_channels,
        multi_query_group_num, seq_length, layernorm_epsilon) — the family
        the reference's WIP fuser targets
        (`python/eetq/models/chatglm.py:41-83`)."""
        num_heads = hf["num_attention_heads"]
        head_dim = hf.get("kv_channels") or hf["hidden_size"] // num_heads
        num_kv = (
            hf["multi_query_group_num"]
            if hf.get("multi_query_attention")
            else num_heads
        )
        return cls(
            vocab_size=hf.get("padded_vocab_size") or hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["ffn_hidden_size"],
            num_layers=hf["num_layers"],
            num_heads=num_heads,
            num_kv_heads=num_kv,
            head_dim=head_dim,
            max_position=hf.get("seq_length", 8192),
            # rotary: adjacent-lane pairing over HALF of head_dim
            rope_theta=10000.0 * hf.get("rope_ratio", 1.0),
            rope_dim=head_dim // 2,
            rope_interleaved=True,
            rms_eps=hf.get("layernorm_epsilon", 1e-5),
            activation="silu",  # swiglu via the fused dense_h_to_4h
            qkv_bias=bool(hf.get("add_qkv_bias", True)),
            tie_word_embeddings=bool(hf.get("tie_word_embeddings", False)),
            model_type="chatglm",
        )


# ---- presets (shapes from the public HF configs) ----

# Tiny llama-shaped config for the CPU parity tests against the JAX package.
TOY = ModelConfig(
    vocab_size=256, hidden_size=128, intermediate_size=256, num_layers=2,
    num_heads=4, num_kv_heads=2, head_dim=32, max_position=2048,
    model_type="llama",
)

TINYLLAMA_1_1B = ModelConfig(
    vocab_size=32000, hidden_size=2048, intermediate_size=5632, num_layers=22,
    num_heads=32, num_kv_heads=4, head_dim=64, max_position=2048,
    model_type="llama",
)

LLAMA2_7B = ModelConfig(
    vocab_size=32000, hidden_size=4096, intermediate_size=11008, num_layers=32,
    num_heads=32, num_kv_heads=32, head_dim=128, max_position=4096,
    model_type="llama",
)

LLAMA2_13B = ModelConfig(
    vocab_size=32000, hidden_size=5120, intermediate_size=13824, num_layers=40,
    num_heads=40, num_kv_heads=40, head_dim=128, max_position=4096,
    model_type="llama",
)

LLAMA2_70B = ModelConfig(
    vocab_size=32000, hidden_size=8192, intermediate_size=28672, num_layers=80,
    num_heads=64, num_kv_heads=8, head_dim=128, max_position=4096,
    model_type="llama",
)

LLAMA3_8B = ModelConfig(
    vocab_size=128256, hidden_size=4096, intermediate_size=14336,
    num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
    max_position=8192, rope_theta=500000.0, model_type="llama",
)

MISTRAL_7B = ModelConfig(
    vocab_size=32000, hidden_size=4096, intermediate_size=14336, num_layers=32,
    num_heads=32, num_kv_heads=8, head_dim=128, max_position=32768,
    sliding_window=4096, model_type="mistral",
)

GEMMA_7B = ModelConfig(
    vocab_size=256000, hidden_size=3072, intermediate_size=24576, num_layers=28,
    num_heads=16, num_kv_heads=16, head_dim=256, max_position=8192,
    activation="gelu", tie_word_embeddings=True,
    embedding_multiplier=3072.0**0.5, rmsnorm_unit_offset=True,
    model_type="gemma",
)

BAICHUAN_7B = ModelConfig(
    vocab_size=125696, hidden_size=4096, intermediate_size=11008, num_layers=32,
    num_heads=32, num_kv_heads=32, head_dim=128, max_position=4096,
    model_type="baichuan",
)

BAICHUAN_13B = ModelConfig(
    vocab_size=64000, hidden_size=5120, intermediate_size=13696, num_layers=40,
    num_heads=40, num_kv_heads=40, head_dim=128, max_position=4096,
    alibi=True, model_type="baichuan",
)

CHATGLM3_6B = ModelConfig(
    vocab_size=65024, hidden_size=4096, intermediate_size=13696,
    num_layers=28, num_heads=32, num_kv_heads=2, head_dim=128,
    max_position=8192, rope_dim=64, rope_interleaved=True, qkv_bias=True,
    model_type="chatglm",
)

# Tiny MoE config (mixtral-shaped) for CPU smoke tests of the routed path.
TOY_MOE = ModelConfig(
    vocab_size=256, hidden_size=128, intermediate_size=256, num_layers=2,
    num_heads=4, num_kv_heads=2, head_dim=32, max_position=2048,
    num_experts=4, num_experts_per_tok=2, model_type="mixtral",
)

MIXTRAL_8X7B = ModelConfig(
    vocab_size=32000, hidden_size=4096, intermediate_size=14336,
    num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
    max_position=32768, rope_theta=1e6, num_experts=8,
    num_experts_per_tok=2, model_type="mixtral",
)

QWEN2_7B = ModelConfig(
    vocab_size=152064, hidden_size=3584, intermediate_size=18944, num_layers=28,
    num_heads=28, num_kv_heads=4, head_dim=128, max_position=32768,
    rope_theta=1e6, rms_eps=1e-6, qkv_bias=True, model_type="qwen2",
)

PRESETS = {
    "toy": TOY,
    "tinyllama-1.1b": TINYLLAMA_1_1B,
    "llama2-7b": LLAMA2_7B,
    "llama2-13b": LLAMA2_13B,
    "llama2-70b": LLAMA2_70B,
    "llama3-8b": LLAMA3_8B,
    "mistral-7b": MISTRAL_7B,
    "gemma-7b": GEMMA_7B,
    "baichuan-7b": BAICHUAN_7B,
    "baichuan-13b": BAICHUAN_13B,
    "chatglm3-6b": CHATGLM3_6B,
    "qwen2-7b": QWEN2_7B,
    "toy-moe": TOY_MOE,
    "mixtral-8x7b": MIXTRAL_8X7B,
}
