"""The data pipeline: synthetic batches (``dummy``), the multiview datasets
and their DSL (``datasets``, ``dsl``), crop / resize and transforms, the
``spawn`` loader and the datamodule.  numpy and PIL only: loader workers
import it and never touch CUDA."""
