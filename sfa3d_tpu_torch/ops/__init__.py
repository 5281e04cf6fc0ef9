"""Device-side ops of the port: BEV raster, cell counts, peak decode."""
