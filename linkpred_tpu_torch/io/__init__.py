"""The MTX reader and writer, and the loader of the native host helpers."""
