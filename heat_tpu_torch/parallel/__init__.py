"""The sharded backend's decomposition: mesh, world, communicators, halo."""
