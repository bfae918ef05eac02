"""The LM substrate's models in PyTorch: configuration, layers, the Mamba
mixer, the MoE layer and the decoder assembly (attn/swa/hymba blocks with
a dense or an MoE feed-forward)."""
