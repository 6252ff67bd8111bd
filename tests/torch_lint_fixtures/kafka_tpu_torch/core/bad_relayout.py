"""kernel-relayout seeds: dense (B, n, p) Jacobian relayouts in core/
outside the sanctioned ``jac_to_rows`` shim."""

import torch


def leak_jacobian_rows(lin, n_bands, p, n):
    jac_rows = lin.jac.permute(0, 2, 1).reshape(n_bands * p, n)  # expect: kernel-relayout
    swapped = torch.transpose(lin.jac, 0, 1)  # expect: kernel-relayout
    return jac_rows, swapped


def leak_method_form(jac, n_bands, p, n):
    flat = jac.reshape(n_bands * p, n)  # expect: kernel-relayout
    packed = jac.contiguous()  # expect: kernel-relayout
    turned = jac.mT  # expect: kernel-relayout
    return flat, packed, turned


def jac_to_rows(jac):
    """A local shim definition is sanctioned — its body never flags."""
    return jac.permute(0, 2, 1).reshape(-1, jac.shape[1]).contiguous()


def relayout_of_other_tensors_is_fine(x, state):
    # Non-Jacobian relayouts are the kernel's normal layout work.
    cols = torch.transpose(x, 0, 1)
    stacked = state.reshape(-1, 4)
    return cols, stacked
