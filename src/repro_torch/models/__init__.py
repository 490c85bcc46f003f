"""Model definitions: the lm family (dense, moe, vlm), the hybrid, the
xLSTM LM and the encoder-decoder, as in the JAX package."""
