"""Violations under inline suppressions — kafkalint must report NOTHING.

Exercises the trailing form, the comment-block-above form, and the
precedence of ``kafkalint: disable`` over the bare-except comment check.
"""

from torch.func import vmap


def hush(x):
    def body(z):
        a = z.sum().item()  # kafkalint: disable=host-transfer-in-jit — parity probe
        # The read below is deliberate: this fixture documents the
        # comment-block form of the directive.
        # kafkalint: disable=host-transfer-in-jit
        b = float(z[0])
        return z + a + b

    return vmap(body)(x)


def quiet(fn):
    try:
        fn()
    except Exception:  # kafkalint: disable=bare-except
        pass
