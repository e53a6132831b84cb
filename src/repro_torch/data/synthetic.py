"""Deterministic synthetic image dataset + the paper's N x C and FedMA's
Dirichlet partitioners, and the IID and quantity-skew controls; and the
synthetic LM corpus (``make_token_dataset``, ``lm_batch_from_tokens``).

CIFAR-10 is not available offline: a class-clustered image dataset
stands in, whose difficulty knobs (prototype separation, noise,
intra-class variation) make FedAvg-vs-Fed2 orderings measurable at
laptop scale. Images are class prototypes (low-frequency random
patterns) composed with instance-specific affine jitter + noise.

Every function draws from numpy ``default_rng`` in exactly the reference
order (``src/repro/data/synthetic.py``), so the same seed gives the same
arrays in both packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ImageDataset:
    images: np.ndarray  # (N, H, W, 3) float32
    labels: np.ndarray  # (N,) int32
    n_classes: int


def make_image_dataset(n: int, n_classes: int = 10, hw: int = 32,
                       seed: int = 0, noise: float = 0.35,
                       jitter: int = 4, proto_seed: int = 1234) \
        -> ImageDataset:
    """``proto_seed`` fixes the class prototypes (shared across train/test
    splits); ``seed`` drives the instance sampling."""
    prng = np.random.default_rng(proto_seed)
    rng = np.random.default_rng(seed)
    # low-frequency class prototypes: upsampled coarse random grids
    coarse = prng.normal(size=(n_classes, hw // 4, hw // 4, 3)).astype(
        np.float32)
    protos = coarse.repeat(4, axis=1).repeat(4, axis=2)
    labels = rng.integers(0, n_classes, size=n).astype(np.int32)
    base = protos[labels]
    # instance jitter: random roll + flip + noise
    images = np.empty((n, hw, hw, 3), np.float32)
    rolls = rng.integers(-jitter, jitter + 1, size=(n, 2))
    flips = rng.random(n) < 0.5
    for i in range(n):
        img = np.roll(base[i], rolls[i], axis=(0, 1))
        if flips[i]:
            img = img[:, ::-1]
        images[i] = img
    images += noise * rng.normal(size=images.shape).astype(np.float32)
    return ImageDataset(images, labels, n_classes)


def nxc_partition(labels: np.ndarray, n_clients: int, classes_per_node: int,
                  n_classes: int, seed: int = 0) -> list[np.ndarray]:
    """Paper's N x C protocol: client j sees only ``classes_per_node``
    classes. Class shards are dealt round-robin so every class is covered
    (and, when ``n_clients * classes_per_node >= n_classes``, every
    sample lands on exactly one client — tests/test_properties.py)."""
    rng = np.random.default_rng(seed)
    # assign class sets: cycle through classes so coverage is uniform
    class_order = rng.permutation(n_classes)
    node_classes = [set() for _ in range(n_clients)]
    ptr = 0
    for j in range(n_clients):
        for _ in range(classes_per_node):
            node_classes[j].add(int(class_order[ptr % n_classes]))
            ptr += 1
    # split each class's indices among the clients that hold it
    idx_by_class = [np.flatnonzero(labels == c) for c in range(n_classes)]
    for c in range(n_classes):
        rng.shuffle(idx_by_class[c])
    holders = {c: [j for j in range(n_clients) if c in node_classes[j]]
               for c in range(n_classes)}
    parts = [[] for _ in range(n_clients)]
    for c in range(n_classes):
        hs = holders[c]
        if not hs:
            continue
        for k, chunk in enumerate(np.array_split(idx_by_class[c], len(hs))):
            parts[hs[k]].append(chunk)
    return [np.concatenate(p) if p else np.empty((0,), np.int64)
            for p in parts]


def dirichlet_partition(labels: np.ndarray, n_clients: int,
                        alpha: float = 0.5, n_classes: int = 10,
                        seed: int = 0) -> list[np.ndarray]:
    """FedMA protocol: each class is dealt to the clients in Dir(alpha)
    proportions (a client's part may be empty)."""
    rng = np.random.default_rng(seed)
    parts = [[] for _ in range(n_clients)]
    for c in range(n_classes):
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        props = rng.dirichlet(alpha * np.ones(n_clients))
        cuts = (np.cumsum(props)[:-1] * len(idx)).astype(int)
        for j, chunk in enumerate(np.split(idx, cuts)):
            parts[j].append(chunk)
    return [np.concatenate(p) for p in parts]


def iid_partition(labels: np.ndarray, n_clients: int,
                  seed: int = 0) -> list[np.ndarray]:
    """IID control: a uniform shuffle split into n_clients equal shards."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(labels))
    return [np.sort(p) for p in np.array_split(order, n_clients)]


def quantity_partition(labels: np.ndarray, n_clients: int,
                       alpha: float = 0.5,
                       seed: int = 0) -> list[np.ndarray]:
    """Quantity skew: shard SIZES follow Dir(alpha) proportions while the
    label distribution stays IID per shard (every client sees every
    class, some clients see far less data). The size-only counterpart of
    ``dirichlet_partition``'s label skew."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(labels))
    props = rng.dirichlet(alpha * np.ones(n_clients))
    cuts = (np.cumsum(props)[:-1] * len(order)).astype(int)
    return [np.sort(p) for p in np.split(order, cuts)]


# ---------------------------------------------------------------------------
# Synthetic LM corpus (vocab-cluster domains)
# ---------------------------------------------------------------------------


def make_token_dataset(n_seqs: int, seq_len: int, vocab: int,
                       n_domains: int = 8, seed: int = 0,
                       in_domain_p: float = 0.9):
    """Per-domain Markov sequences concentrated on contiguous vocab
    clusters (the LM analog of class-clustered images, matching Fed2's
    vocab-cluster groups). Returns (tokens (n, L) int32, domains (n,)
    int32)."""
    rng = np.random.default_rng(seed)
    cluster = vocab // n_domains
    domains = rng.integers(0, n_domains, size=n_seqs).astype(np.int32)
    toks = np.empty((n_seqs, seq_len), np.int32)
    # per-domain sparse bigram structure inside the cluster
    n_modes = 32
    mode_next = rng.integers(0, cluster, size=(n_domains, n_modes, 4))
    for i in range(n_seqs):
        d = domains[i]
        lo = d * cluster
        t = rng.integers(0, cluster)
        for s in range(seq_len):
            if rng.random() < in_domain_p:
                m = t % n_modes
                t = int(mode_next[d, m, rng.integers(0, 4)])
                toks[i, s] = lo + t
            else:
                toks[i, s] = rng.integers(0, vocab)
                t = rng.integers(0, cluster)
    return toks, domains


def lm_batch_from_tokens(toks: np.ndarray, *, device) -> dict:
    """Next-token prediction batch on ``device`` from raw sequences (n,
    L + 1): tokens and labels (n, L) int64, mask (n, L) fp32 ones."""
    x = torch.as_tensor(toks[:, :-1], dtype=torch.long, device=device)
    y = torch.as_tensor(toks[:, 1:], dtype=torch.long, device=device)
    return {"tokens": x, "labels": y,
            "mask": torch.ones(y.shape, dtype=torch.float32, device=device)}
