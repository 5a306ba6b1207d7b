"""Model zoo of the port (counterpart of ``repro.models``): the shared
layers and the decoder-only transformer's serving path."""
