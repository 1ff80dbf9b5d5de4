"""The port's models: the AST (`models.ast`) and BEATs (`models.beats`).
Each module has `init_params`, `cast_params`, `forward`, `pool`,
`classify`, `ATTENTION_IMPLS` and its `FRONT_END` (`ops.fbank.FrontEnd`);
`module_for` picks the one a configuration belongs to."""


def module_for(config):
    """`models.ast` for an `ASTConfig`, `models.beats` for a `BEATsConfig`."""
    from . import ast, beats

    if isinstance(config, beats.BEATsConfig):
        return beats
    if isinstance(config, ast.ASTConfig):
        return ast
    raise TypeError(f"no model takes a {type(config).__name__}; expected an "
                    "ASTConfig or a BEATsConfig")
