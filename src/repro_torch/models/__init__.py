"""The LM substrate's models in PyTorch: configuration, layers, the Mamba
mixer and the decoder assembly (attn/swa/hymba blocks)."""
