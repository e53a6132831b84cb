"""Synthetic datasets and federated partitioners."""
