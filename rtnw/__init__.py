"""Differentiable path tracer in JAX for NVIDIA GPUs.

A from-scratch JAX/XLA/Pallas re-design of the capability set of the CUDA
reference renderer `erosnick/RayTracingTheNextWeekCUDA` ("Ray Tracing The Next
Week" feature set): spheres (static + motion-blurred), finite oriented planes,
cubes, OBJ/PLY triangle meshes, an LBVH acceleration structure, thin-lens
camera with defocus + motion blur, lambertian/metal/dielectric/emissive
materials (plus the second engine's DIFFUSE/METAL/SPECULAR/COAT/REFRACTION
set), YAML scene files, progressive accumulation, offline + interactive
frontends — rebuilt as a wavefront integrator that is end-to-end
differentiable and shards over device meshes, plus a per-pixel render
kernel (Pallas through Triton) for forward rendering on the GPU.

Layout:
    ops/       batched intersection, BSDF, sampling, BVH build + traversal,
               the Pallas megastep kernel
    models/    scene pytrees, camera, film, wavefront integrator, presets
    io/        YAML scenes (reference-schema compatible), OBJ/PLY, PNG/PPM,
               BVH cache
    parallel/  device-mesh sharding of tiles/wavefronts, distributed gradient
               steps
    utils/     timing, progress, logging
"""

from rtnw.config import RenderConfig

__all__ = ["RenderConfig"]
__version__ = "0.1.0"
