"""The MTX reader and writer, npz graph files, and the loader of the native
host helpers."""
