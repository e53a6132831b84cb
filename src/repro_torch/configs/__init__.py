"""Model configurations (the paper's VGG9)."""
