"""A protocol that hands ``self.forward_pixel`` to ``torch.func.vmap``:
every override of ``forward_pixel`` in the tree is a device region."""

from torch.func import vmap


class Model:
    def forward(self, aux, x):
        return vmap(self.forward_pixel)(aux, x)

    def forward_pixel(self, aux, x):
        raise NotImplementedError
