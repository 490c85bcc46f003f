"""Model definitions.  Only the dense decoder-only LM is ported."""
