"""Handle, environment knobs and the typed errors of the port."""
