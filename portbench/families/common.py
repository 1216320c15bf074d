"""What the harness takes from a built model: its step, the macro cell
centers, the kernel launch counters, the macro solve's iteration counts, and
the homogenized tensors A* that each step's micro stage returned."""

from __future__ import annotations

import importlib

__all__ = ["System", "AstarProbe"]


class AstarProbe:
    """Keeps the value of the last ``MicroEngine.tensors_for_centers`` call,
    the micro stage's A* in a ``build_pipeline`` step, by wrapping the
    public method on its class while the probe is installed."""

    def __init__(self):
        from hommx_tpu_torch.micro.engine import MicroEngine

        self._cls = MicroEngine
        self._orig = MicroEngine.tensors_for_centers
        self.last = None
        orig, probe = self._orig, self

        def tensors_for_centers(engine, *args, **kwargs):
            out = orig(engine, *args, **kwargs)
            probe.last = out
            return out

        MicroEngine.tensors_for_centers = tensors_for_centers

    def remove(self) -> None:
        self._cls.tensors_for_centers = self._orig
        self.last = None


class System:
    """A model under test: ``step(centers) -> u`` and what a run reads."""

    def __init__(self, model, step, centers, launchers: dict, chunk_launcher: str):
        self.model = model
        self.step = step
        self._pipeline_step = step
        self.centers = centers
        self._launchers = {label: (importlib.import_module(mod).KERNEL, name)
                           for label, (mod, name) in launchers.items()}
        #: the label of the launcher that takes one chunk of cells a launch
        self.chunk_launcher = chunk_launcher

    def launches(self) -> dict:
        """Launches so far of each launcher the family names."""
        return {label: int(k.counts.get(name, 0)) for label, (k, name) in self._launchers.items()}

    def macro_iterations(self) -> list:
        """Iterations of every macro solve the step ran (0 for a direct
        solve)."""
        return list(getattr(self._pipeline_step.macro_solve, "iterations", []))

    def macro_mesh(self):
        """(vertices, cells) of the model's macro mesh, numpy."""
        mesh = self.model.function_space.mesh
        return mesh.vertices, mesh.cells
