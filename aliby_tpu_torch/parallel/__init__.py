"""Multi-position runners: threads over devices (``positions``) and many
positions through one fused call a chunk (``pipeline_mesh``)."""
