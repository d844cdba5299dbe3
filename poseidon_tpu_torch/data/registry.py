"""Dataset selector — behavioral mirror of ``get_dataset``
(the reference scOT, problems/base.py:15-161).

Name grammar (identical to the reference README's code identifiers):
  fluids.incompressible.{BrownianBridge,Gaussians,ShearLayer,Sines,
                         PiecewiseConstants,VortexSheet}[.tracer]
  fluids.incompressible.forcing.KolmogorovFlow
  fluids.compressible.{Riemann,RiemannCurved,RiemannKelvinHelmholtz,
                       KelvinHelmholtz,Gaussians,RichtmyerMeshkov[.tracer]}
  fluids.compressible.gravity.RayleighTaylor[.tracer]
  fluids.compressible.steady.Airfoil[.time]
  elliptic.poisson.Gaussians[.time]
  elliptic.Helmholtz[.time]
  wave.Layer | wave.Gaussians
  reaction_diffusion.AllenCahn

Suffixes: ``.out`` selects the longer-horizon eval settings; ``.tracer`` adds
the passive-tracer channel; ``.time`` wraps a steady dataset for
time-conditioned models. A list of names yields a ConcatDataset (mixed-dataset
pretraining).

The port's copy of ``poseidon_tpu/data/registry.py``.
"""

from __future__ import annotations

from typing import Union

from .base import ConcatDataset, TimeWrapper


def get_dataset(dataset: Union[str, list], **kwargs):
    if isinstance(dataset, (list, tuple)):
        return ConcatDataset([get_dataset(d, **kwargs) for d in dataset])

    name = dataset
    is_out = "out" in name
    tracer = "tracer" in name

    if "fluids" in name:
        from . import fluids

        if "fluids.incompressible" in name:
            table = {
                "BrownianBridge": fluids.BrownianBridge,
                "Gaussians": fluids.Gaussians,
                "ShearLayer": fluids.ShearLayer,
                "Sines": fluids.Sines,
                "PiecewiseConstants": fluids.PiecewiseConstants,
                "VortexSheet": fluids.VortexSheet,
            }
            dset = None
            for key, cls in table.items():
                if key in name:
                    dset = cls
                    break
            if dset is None:
                if "forcing" in name and "KolmogorovFlow" in name:
                    dset = fluids.KolmogorovFlow
                else:
                    raise ValueError(f"Unknown dataset {name}")
        elif "fluids.compressible" in name:
            if "gravity" in name:
                if "RayleighTaylor" not in name:
                    raise ValueError(f"Unknown dataset {name}")
                dset = fluids.RayleighTaylor
                defaults = ({"max_num_time_steps": 10, "time_step_size": 1}
                            if is_out else
                            {"max_num_time_steps": 7, "time_step_size": 1})
                kwargs = {**defaults, **kwargs}
            elif "RiemannKelvinHelmholtz" in name:
                dset = fluids.RiemannKelvinHelmholtz
            elif "RiemannCurved" in name:
                dset = fluids.RiemannCurved
            elif "Riemann" in name:
                dset = fluids.Riemann
            elif "KelvinHelmholtz" in name:
                dset = fluids.KelvinHelmholtz
            elif "Gaussians" in name:
                dset = fluids.CompressibleGaussians
            elif "RichtmyerMeshkov" in name:
                dset = fluids.RichtmyerMeshkov
            elif "steady" in name:
                if "steady.Airfoil" not in name or is_out:
                    raise ValueError(f"Unknown dataset {name}")
                dset = fluids.Airfoil
            else:
                raise ValueError(f"Unknown dataset {name}")
        else:
            raise ValueError(f"Unknown dataset {name}")
        if "steady" not in name:
            defaults = ({"max_num_time_steps": 10, "time_step_size": 2}
                        if is_out else
                        {"max_num_time_steps": 7, "time_step_size": 2})
            kwargs = {"tracer": tracer, **defaults, **kwargs}
    elif "elliptic" in name:
        if ".out" in name:
            raise NotImplementedError(f"Unknown dataset {name}")
        if "elliptic.poisson" in name:
            if "Gaussians" not in name:
                raise ValueError(f"Unknown dataset {name}")
            from .elliptic import PoissonGaussians as dset
        elif "elliptic.Helmholtz" in name:
            from .elliptic import Helmholtz as dset
        else:
            raise ValueError(f"Unknown dataset {name}")
    elif "wave" in name:
        from . import wave

        if "wave.Layer" in name:
            dset = wave.Layer
            defaults = ({"max_num_time_steps": 10, "time_step_size": 2}
                        if is_out else
                        {"max_num_time_steps": 7, "time_step_size": 2})
            kwargs = {**defaults, **kwargs}
        elif "wave.Gaussians" in name:
            if is_out:
                raise ValueError(f"Unknown dataset {name}")
            dset = wave.WaveGaussians
            kwargs = {"max_num_time_steps": 7, "time_step_size": 2, **kwargs}
        else:
            raise ValueError(f"Unknown dataset {name}")
    elif "reaction_diffusion" in name:
        if "reaction_diffusion.AllenCahn" not in name:
            raise ValueError(f"Unknown dataset {name}")
        from .reaction_diffusion import AllenCahn as dset

        defaults = ({"max_num_time_steps": 9, "time_step_size": 2}
                    if is_out else
                    {"max_num_time_steps": 7, "time_step_size": 2})
        kwargs = {**defaults, **kwargs}
    else:
        raise ValueError(f"Unknown dataset {name}")

    ds = dset(**kwargs)
    return TimeWrapper(ds) if ".time" in name else ds
