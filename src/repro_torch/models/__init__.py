"""The LM substrate's models in PyTorch: configuration, layers, the
recurrent mixers (Mamba, mLSTM, sLSTM), the MoE layer and the decoder
assembly (attn/swa/hymba/mamba/mlstm/slstm blocks with a dense, an MoE or
no feed-forward)."""
