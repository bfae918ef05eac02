"""The LM substrate's models in PyTorch: configuration, layers, the
recurrent mixers (Mamba, mLSTM, sLSTM), the MoE layer and the model
assembly (attn/swa/hymba/mamba/mlstm/slstm decoder blocks with a dense,
an MoE or no feed-forward, rotary or learned positions, and whisper's
encoder with cross-attention in every decoder block)."""
