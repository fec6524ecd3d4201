"""Command-line examples of the port, run as modules:

    python -m odil_torch.examples.veltracer --Nt 64 --Nx 256 --Ny 256 --kernel pallas_mg --epochs 400
    python -m odil_torch.examples.wave --epochs 200
    python -m odil_torch.examples.heat --infer_k 1 --imposed stripe --kernel pallas --epochs 1500
    python -m odil_torch.examples.poisson --N 64 --ref osc --rhs exact --epochs 1000
    python -m odil_torch.examples.infer_constant --epochs 100
    python -m odil_torch.examples.heat_tmax --epochs 4000
    python -m odil_torch.examples.fields --plot 0 --epochs 100

Each takes the flags of the JAX package's example of the same name plus
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain versions).
"""
