"""`"update": "none"`: the scene stays as composed."""

from . import Update  # noqa: F401
