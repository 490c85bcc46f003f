"""Neural-network building blocks (plain functions on tensors; parameters
are dicts of tensors): what the lm family (dense, moe, vlm) needs.  The
SSM and xLSTM layers come with ROADMAP A8b-2."""
