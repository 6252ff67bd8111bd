"""Seeded forward-state-mutation-in-smoother violations: the
RTS backward pass is read-only over the checkpoint chain — writing a
checkpoint set or a chain node's forward fields from the smoother
package breaks the any-replica-can-serve-it contract."""

import numpy as np


def rewind_chain(checkpointer, timestep, x_s, p_s_inv):
    checkpointer.save(timestep, x_s, p_s_inv)  # expect: forward-state-mutation-in-smoother


def patch_node_in_place(node, x_s, p_f_inv):
    node.x_analysis = x_s  # expect: forward-state-mutation-in-smoother
    node.sidecar = (x_s, p_f_inv)  # expect: forward-state-mutation-in-smoother
    return node


def overwrite_shard(path, x, p_inv):
    with open(path, "wb") as f:
        np.savez_compressed(f, x_analysis=x, p_inv_tril=p_inv)  # expect: forward-state-mutation-in-smoother
