"""Core simulation engine: init, forces, decay, overlap, frame step."""
