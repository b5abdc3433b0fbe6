"""SD-1.x stack: conditional UNet, CLIP text encoder, VAE decoder, and the
weight carrier from the JAX package's parameter trees."""
