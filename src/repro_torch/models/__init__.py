"""Language-model stack of the port (dense transformers): counterpart of ``repro.models``."""
