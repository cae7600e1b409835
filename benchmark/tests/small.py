"""Small sizes of the cells' configurations, for the CPU."""
AIRCRAFT = dict(dim=32, heads=2, layers=1, batch=4, points=16, timesteps=50)
PROTEIN = dict(dim=32, heads=2, t_depth=1, c_depth=3, batch=4, receptor_len=12, ligand_len=6,
               min_receptor_len=9, min_ligand_len=4, timesteps=50)
# a chain short enough that the untrained small model stays bounded
SAMPLE_TRAFFIC = dict(sampler_steps=4)
CELLS = {"aircraft-train": (AIRCRAFT, None), "protein-train": (PROTEIN, None),
         "protein-sample": (PROTEIN, SAMPLE_TRAFFIC)}
