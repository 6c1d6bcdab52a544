"""Device-side compute core in PyTorch: vectors, RNG, camera, environment,
BRDF, tonemapping and the wavefront path-tracing integrator."""
