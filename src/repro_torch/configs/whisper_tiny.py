"""whisper-tiny — encoder-decoder ASR; conv frontend is a STUB
(input_specs provides precomputed 1500-frame embeddings).
[arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny", family="audio",
    num_layers=4, d_model=384, num_heads=6, num_kv_heads=6,
    d_ff=1536, vocab_size=51865,
    block_pattern=("full",),
    norm="layer", mlp="gelu",
    encoder_decoder=True, enc_layers=4, enc_seq=1500,
    frontend="audio",
    supports_long_context=False,   # enc-dec; 500k decode out of envelope
    notes="decoder shapes lower serve_step for the decoder",
)
