"""Engine, static layout, decode state, n-gram pool and the decode step."""
from .layout import Layout, build_layout
from .engine import LookaheadEngine, GenerationResult
from .state import DecodeState
