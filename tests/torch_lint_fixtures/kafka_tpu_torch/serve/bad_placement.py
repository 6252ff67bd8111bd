"""Seeded nondeterministic-placement violations: salted /
random routing decisions in a placement-bearing tree."""

import random


def pick_owner(tile, replicas):
    idx = hash(tile) % len(replicas)  # expect: nondeterministic-placement
    return replicas[idx]


def spread(tile, replicas):
    return random.choice(replicas)  # expect: nondeterministic-placement


def jittered_shard(chunks, rng):
    import numpy as np

    order = np.random.permutation(len(chunks))  # expect: nondeterministic-placement
    return [chunks[i] for i in order]
