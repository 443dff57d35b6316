"""HuBERT-XLarge: an encoder-only audio transformer (the wav2vec 2.0
architecture) [arXiv:2106.07447].

The same widths as ``repro.configs.hubert_xlarge``: 48 layers, d 1280, 16
heads of 80, GELU MLP 5120, LayerNorm with eps 1e-5, non-causal
attention, no rope. The mel-spectrogram and convolutional feature
extractor are stubbed, as in the reference: a batch brings precomputed
frame features (B, S, 512) that the model projects to d_model, masked
frames take a learned embedding, and a sinusoidal table gives the
positions. The objective is masked prediction over the 504-class
codebook. Encoder-only: no decode step.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "hubert-xlarge"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        arch_type="audio",
        num_layers=48,
        d_model=1280,
        num_heads=16,
        num_kv_heads=16,
        head_dim=80,
        d_ff=5120,
        vocab_size=504,
        causal=False,
        rope_style="none",
        audio_feat_dim=512,
        norm_eps=1e-5,
        act="gelu",
    )


def smoke() -> ModelConfig:
    return config().replace(
        name=ARCH_ID + "-smoke", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=4, head_dim=64, d_ff=512, vocab_size=64,
        audio_feat_dim=32)
