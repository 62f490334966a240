"""whisper-tiny [audio]: 4L d_model=384 6H d_ff=1536 vocab=51865;
encoder-decoder; conv frontend is a STUB (input_specs provides precomputed
frame embeddings).  [arXiv:2212.04356; unverified]"""
from ._common import full, smoke

# 4 encoder + 4 decoder layers (enc-dec); frontend stub supplies
# (B, 1500, 384) frame embeddings (30s of audio at 50 Hz after conv stack).
CONFIG = full(
    name="whisper-tiny", family="encdec",
    n_layers=4, n_encoder_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_head=64, d_ff=1536, vocab=51865, act="relu", frontend="audio",
    frontend_tokens=1500)

SMOKE = smoke(
    name="whisper-smoke", family="encdec",
    n_layers=2, n_encoder_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
    d_head=8, d_ff=32, vocab=128, act="relu", frontend="audio",
    frontend_tokens=8)
