"""Command-line tools of the port, run as modules:

    python -m odil_torch.tools.plot_field field.xdmf2 [--out field.png] [--cmap viridis] [--slice K]
"""
