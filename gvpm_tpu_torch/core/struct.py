"""Plain dataclasses of tensors: the port's counterpart of the JAX
package's flax.struct pytrees."""

from __future__ import annotations

import dataclasses

import torch


class TensorStruct:
    """Mixin for a @dataclass whose fields are tensors (other fields are
    carried through unchanged)."""

    def map(self, fn):
        """A copy with `fn` applied to every tensor field."""
        return dataclasses.replace(self, **{
            f.name: fn(getattr(self, f.name))
            for f in dataclasses.fields(self)
            if torch.is_tensor(getattr(self, f.name))})

    def to(self, device):
        return self.map(lambda a: a.to(device))

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def asdict(self):
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}
