"""Command-line examples of the port, run as modules:

    python -m odil_torch.examples.veltracer --Nt 64 --Nx 256 --Ny 256 --kernel pallas_mg --epochs 400
    python -m odil_torch.examples.wave --optimizer lbfgsb --epochs 200

Each takes the flags of the JAX package's example of the same name plus
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain versions).
"""
