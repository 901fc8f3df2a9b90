"""Training: features, the sequence model, its loss, AdamW, the sparsifier and the exports."""
