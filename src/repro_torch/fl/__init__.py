"""Federated runtime: methods, population, round engine, evaluation."""
