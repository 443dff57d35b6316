"""The ViT model: params, layers and the forward pass."""
