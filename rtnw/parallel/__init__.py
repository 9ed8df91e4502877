"""Multi-device scaling: device meshes, tile-sharded rendering, psum'd gradients."""
