"""Legacy basis-tooling CLI parser.

Port of the reference's standalone `<geometry.xyz> <basis_name>` argument
parser (mqc_cli_parser.f90:29-96), used by the
basis-reader tooling rather than the main program. Returns the parsed pair
or raises ParseError; `-h`/`--help` raises HelpRequested after printing
usage, mirroring the reference's HELP_REQUESTED marker.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..errors import ParseError


class HelpRequested(Exception):
    """Raised after printing usage for -h/--help (mqc_cli_parser.f90:54-58)."""


@dataclass
class CliArgs:
    xyz_file: str
    basis_name: str


def print_usage(prog_name: str = "pic_basis_reader") -> None:
    print()
    print(f"Usage: {prog_name} <geometry.xyz> <basis_name>")
    print()
    print("Arguments:")
    print("  geometry.xyz   Path to XYZ geometry file")
    print("  basis_name     Basis set name (e.g. cc-pvdz, sto-3g)")
    print()
    print("Options:")
    print("  -h, --help     Show this help message")
    print()


def parse_command_line(argv) -> CliArgs:
    """Parse `<geometry.xyz> <basis_name>` (mqc_cli_parser.f90:29-92).

    argv: the argument list WITHOUT the program name.
    """
    if argv and argv[0] in ("-h", "--help"):
        print_usage()
        raise HelpRequested()
    if len(argv) < 2:
        print_usage()
        raise ParseError(
            "Error: Insufficient arguments. Expected 2 arguments "
            "(geometry.xyz basis_name)"
        )
    if len(argv) > 2:
        print_usage()
        raise ParseError(
            "Error: Too many arguments. Expected 2 arguments "
            "(geometry.xyz basis_name)"
        )
    return CliArgs(xyz_file=argv[0], basis_name=argv[1])
