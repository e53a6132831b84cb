"""CNN model family: parameters as nested dicts of tensors."""
