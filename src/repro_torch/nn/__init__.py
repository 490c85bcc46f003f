"""Neural-network building blocks (plain functions on tensors; parameters
are dicts of tensors): embeddings, norms, attention, the MLP, MoE, the
Mamba2 (SSD) block, the xLSTM blocks and the chunked GLA they run on."""
