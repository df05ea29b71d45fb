"""Model stages: patch embed, encoder, decoder, DPT head, full model."""
