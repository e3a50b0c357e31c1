"""FAST pyramid and static / dense-object sampling."""
