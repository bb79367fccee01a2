"""Tools that bridge the JAX package and the PyTorch port; they import
both, so they run where JAX is installed, not on the card's machine."""
