"""Runtime layer: the progressive renderer and its framebuffer layout."""
