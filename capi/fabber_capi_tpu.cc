/* fabber_capi_tpu.cc - Pure C API for the JAX fabber framework.
 *
 * Native shared library for language bindings, with the same ABI shape
 * as the reference libfabbercore_shared (fabber_capi.h:40-279):
 * fabber_new / fabber_set_extent / fabber_set_opt / fabber_set_data /
 * fabber_dorun / fabber_get_data / introspection / model evaluation.
 *
 * The compute engine is the fabber_core_tpu Python package (JAX/XLA);
 * this library embeds CPython when loaded from a non-Python host, or
 * attaches to the already-running interpreter when loaded via ctypes
 * from Python. All buffer marshalling is done here in C++.
 *
 * Build: see capi/Makefile. The environment variable
 * FABBER_TPU_PYTHONPATH may list extra sys.path entries (e.g. a
 * virtualenv's site-packages and the package checkout) separated by
 * ':'.
 */

#include <Python.h>

#include <cstdio>
#include <cstring>
#include <string>

#define FABBER_ERR_MAXC 255
#define FABBER_ERR_FATAL -255
#define FABBER_ERR_NEWMAT -254

extern "C" {

struct FabberContext
{
    PyObject *backend; /* fabber_core_tpu.capi_backend.CApiContext */
};

static bool g_we_initialized_python = false;

static void set_err(char *err_buf, const char *msg)
{
    if (err_buf)
    {
        strncpy(err_buf, msg, FABBER_ERR_MAXC - 1);
        err_buf[FABBER_ERR_MAXC - 1] = 0;
    }
}

/* Capture the current Python exception into err_buf */
static void set_err_from_python(char *err_buf)
{
    PyObject *ptype = NULL, *pvalue = NULL, *ptrace = NULL;
    PyErr_Fetch(&ptype, &pvalue, &ptrace);
    PyErr_NormalizeException(&ptype, &pvalue, &ptrace);
    if (pvalue)
    {
        PyObject *s = PyObject_Str(pvalue);
        if (s)
        {
            const char *msg = PyUnicode_AsUTF8(s);
            set_err(err_buf, msg ? msg : "Unknown Python error");
            Py_DECREF(s);
        }
    }
    else
    {
        set_err(err_buf, "Unknown error");
    }
    Py_XDECREF(ptype);
    Py_XDECREF(pvalue);
    Py_XDECREF(ptrace);
}

static void ensure_python()
{
    if (!Py_IsInitialized())
    {
        Py_InitializeEx(0);
        g_we_initialized_python = true;
        /* Release the GIL acquired by initialization so that
           PyGILState_Ensure works uniformly below */
        PyEval_SaveThread();
    }
}

/* Add FABBER_TPU_PYTHONPATH entries to sys.path */
static void extend_sys_path()
{
    const char *extra = getenv("FABBER_TPU_PYTHONPATH");
    if (!extra)
        return;
    PyObject *sys_path = PySys_GetObject("path"); /* borrowed */
    if (!sys_path)
        return;
    std::string paths(extra);
    size_t start = 0;
    while (start <= paths.size())
    {
        size_t end = paths.find(':', start);
        if (end == std::string::npos)
            end = paths.size();
        std::string p = paths.substr(start, end - start);
        if (!p.empty())
        {
            PyObject *entry = PyUnicode_FromString(p.c_str());
            if (entry)
            {
                PyList_Insert(sys_path, 0, entry);
                Py_DECREF(entry);
            }
        }
        start = end + 1;
    }
}

void *fabber_new(char *err_buf)
{
    ensure_python();
    PyGILState_STATE gil = PyGILState_Ensure();
    void *result = NULL;

    extend_sys_path();
    PyObject *mod = PyImport_ImportModule("fabber_core_tpu.capi_backend");
    if (!mod)
    {
        set_err_from_python(err_buf);
        PyGILState_Release(gil);
        return NULL;
    }
    PyObject *ctx = PyObject_CallMethod(mod, "CApiContext", NULL);
    Py_DECREF(mod);
    if (!ctx)
    {
        set_err_from_python(err_buf);
        PyGILState_Release(gil);
        return NULL;
    }
    FabberContext *fc = new FabberContext;
    fc->backend = ctx;
    result = fc;
    PyGILState_Release(gil);
    return result;
}

void fabber_destroy(void *fab)
{
    if (!fab)
        return;
    FabberContext *fc = (FabberContext *)fab;
    PyGILState_STATE gil = PyGILState_Ensure();
    Py_XDECREF(fc->backend);
    PyGILState_Release(gil);
    delete fc;
}

/* Call a backend method returning None; -255 on error */
static int call_int_method(void *fab, char *err_buf, const char *name,
    const char *fmt, ...)
{
    if (!fab)
    {
        set_err(err_buf, "NULL context");
        return FABBER_ERR_FATAL;
    }
    FabberContext *fc = (FabberContext *)fab;
    PyGILState_STATE gil = PyGILState_Ensure();
    va_list args;
    va_start(args, fmt);
    PyObject *meth = PyObject_GetAttrString(fc->backend, name);
    PyObject *ret = NULL;
    if (meth)
    {
        PyObject *pyargs = Py_VaBuildValue(fmt, args);
        if (pyargs)
        {
            ret = PyObject_CallObject(meth, pyargs);
            Py_DECREF(pyargs);
        }
        Py_DECREF(meth);
    }
    va_end(args);
    int rc = 0;
    if (!ret)
    {
        set_err_from_python(err_buf);
        rc = FABBER_ERR_FATAL;
    }
    else
    {
        Py_DECREF(ret);
    }
    PyGILState_Release(gil);
    return rc;
}

/* Call a backend method returning str; copy into out_buf */
static int call_str_method(void *fab, unsigned int out_bufsize, char *out_buf,
    char *err_buf, const char *name, const char *fmt, ...)
{
    if (!fab)
    {
        set_err(err_buf, "NULL context");
        return FABBER_ERR_FATAL;
    }
    FabberContext *fc = (FabberContext *)fab;
    PyGILState_STATE gil = PyGILState_Ensure();
    va_list args;
    va_start(args, fmt);
    PyObject *meth = PyObject_GetAttrString(fc->backend, name);
    PyObject *ret = NULL;
    if (meth)
    {
        PyObject *pyargs = fmt ? Py_VaBuildValue(fmt, args) : PyTuple_New(0);
        if (pyargs)
        {
            ret = PyObject_CallObject(meth, pyargs);
            Py_DECREF(pyargs);
        }
        Py_DECREF(meth);
    }
    va_end(args);
    int rc = 0;
    if (!ret)
    {
        set_err_from_python(err_buf);
        rc = FABBER_ERR_FATAL;
    }
    else
    {
        const char *s = PyUnicode_AsUTF8(ret);
        if (s && out_buf && strlen(s) < out_bufsize)
        {
            strcpy(out_buf, s);
        }
        else if (s && out_buf)
        {
            /* buffer too small: return empty output per reference */
            if (out_bufsize > 0)
                out_buf[0] = 0;
        }
        Py_DECREF(ret);
    }
    PyGILState_Release(gil);
    return rc;
}

int fabber_load_models(void *fab, const char *libpath, char *err_buf)
{
    if (!libpath || !*libpath)
    {
        set_err(err_buf, "Library path is null or empty");
        return FABBER_ERR_FATAL;
    }
    return call_int_method(fab, err_buf, "load_models", "(s)", libpath);
}

int fabber_set_extent(void *fab, unsigned int nx, unsigned int ny,
    unsigned int nz, const int *mask, char *err_buf)
{
    if (nx * ny * nz == 0)
    {
        set_err(err_buf, "Extent must be non-zero in all dimensions");
        return FABBER_ERR_FATAL;
    }
    FabberContext *fc = (FabberContext *)fab;
    if (!fc)
    {
        set_err(err_buf, "NULL context");
        return FABBER_ERR_FATAL;
    }
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject *mask_obj;
    if (mask)
        mask_obj = PyBytes_FromStringAndSize(
            (const char *)mask, (Py_ssize_t)nx * ny * nz * sizeof(int));
    else
    {
        mask_obj = Py_None;
        Py_INCREF(Py_None);
    }
    PyObject *ret = PyObject_CallMethod(
        fc->backend, "set_extent", "(IIIO)", nx, ny, nz, mask_obj);
    Py_DECREF(mask_obj);
    int rc = 0;
    if (!ret)
    {
        set_err_from_python(err_buf);
        rc = FABBER_ERR_FATAL;
    }
    else
        Py_DECREF(ret);
    PyGILState_Release(gil);
    return rc;
}

int fabber_set_opt(void *fab, const char *key, const char *value, char *err_buf)
{
    if (!key || !*key || !value)
    {
        set_err(err_buf, "Option key was null or empty");
        return FABBER_ERR_FATAL;
    }
    return call_int_method(fab, err_buf, "set_opt", "(ss)", key, value);
}

int fabber_set_data(void *fab, const char *name, unsigned int data_size,
    const float *data, char *err_buf)
{
    if (!name || !*name || !data || data_size == 0)
    {
        set_err(err_buf, "Data name/buffer was null or empty");
        return FABBER_ERR_FATAL;
    }
    FabberContext *fc = (FabberContext *)fab;
    if (!fc)
    {
        set_err(err_buf, "NULL context");
        return FABBER_ERR_FATAL;
    }
    PyGILState_STATE gil = PyGILState_Ensure();
    /* nvoxels known backend-side; ask it for the expected byte count */
    PyObject *nbytes_obj = PyObject_CallMethod(
        fc->backend, "data_nbytes", "(I)", data_size);
    int rc = 0;
    if (!nbytes_obj)
    {
        set_err_from_python(err_buf);
        rc = FABBER_ERR_FATAL;
    }
    else
    {
        Py_ssize_t nbytes = PyLong_AsSsize_t(nbytes_obj);
        Py_DECREF(nbytes_obj);
        PyObject *buf = PyBytes_FromStringAndSize((const char *)data, nbytes);
        PyObject *ret = buf ? PyObject_CallMethod(fc->backend, "set_data",
                                  "(sIO)", name, data_size, buf)
                            : NULL;
        Py_XDECREF(buf);
        if (!ret)
        {
            set_err_from_python(err_buf);
            rc = FABBER_ERR_FATAL;
        }
        else
            Py_DECREF(ret);
    }
    PyGILState_Release(gil);
    return rc;
}

int fabber_get_data_size(void *fab, const char *name, char *err_buf)
{
    FabberContext *fc = (FabberContext *)fab;
    if (!fc || !name || !*name)
    {
        set_err(err_buf, "NULL context or name");
        return FABBER_ERR_FATAL;
    }
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject *ret = PyObject_CallMethod(fc->backend, "get_data_size", "(s)", name);
    int rc;
    if (!ret)
    {
        set_err_from_python(err_buf);
        rc = FABBER_ERR_FATAL;
    }
    else
    {
        rc = (int)PyLong_AsLong(ret);
        Py_DECREF(ret);
    }
    PyGILState_Release(gil);
    return rc;
}

int fabber_get_data(void *fab, const char *name, float *data_buf, char *err_buf)
{
    FabberContext *fc = (FabberContext *)fab;
    if (!fc || !name || !*name || !data_buf)
    {
        set_err(err_buf, "NULL context, name or buffer");
        return FABBER_ERR_FATAL;
    }
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject *ret = PyObject_CallMethod(fc->backend, "get_data", "(s)", name);
    int rc = 0;
    if (!ret)
    {
        set_err_from_python(err_buf);
        rc = FABBER_ERR_FATAL;
    }
    else
    {
        char *bytes;
        Py_ssize_t nbytes;
        if (PyBytes_AsStringAndSize(ret, &bytes, &nbytes) == 0)
            memcpy(data_buf, bytes, nbytes);
        else
        {
            set_err_from_python(err_buf);
            rc = FABBER_ERR_FATAL;
        }
        Py_DECREF(ret);
    }
    PyGILState_Release(gil);
    return rc;
}

/* Progress callback trampoline: C function pointer wrapped as a
 * Python callable via a capsule */
static PyObject *progress_trampoline(PyObject *self, PyObject *args)
{
    void (*cb)(int, int)
        = (void (*)(int, int))PyCapsule_GetPointer(self, "fabber_progress_cb");
    int voxel = 0, nvoxels = 0;
    if (!PyArg_ParseTuple(args, "ii", &voxel, &nvoxels))
        return NULL;
    if (cb)
        cb(voxel, nvoxels);
    Py_RETURN_NONE;
}

static PyMethodDef progress_def
    = { "progress", progress_trampoline, METH_VARARGS, NULL };

int fabber_dorun(void *fab, unsigned int log_bufsize, char *log_buf,
    char *err_buf, void (*progress_cb)(int, int))
{
    FabberContext *fc = (FabberContext *)fab;
    if (!fc)
    {
        set_err(err_buf, "NULL context");
        return FABBER_ERR_FATAL;
    }
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject *cb_obj;
    if (progress_cb)
    {
        PyObject *capsule
            = PyCapsule_New((void *)progress_cb, "fabber_progress_cb", NULL);
        cb_obj = PyCFunction_New(&progress_def, capsule);
        Py_XDECREF(capsule);
    }
    else
    {
        cb_obj = Py_None;
        Py_INCREF(Py_None);
    }
    PyObject *ret = PyObject_CallMethod(fc->backend, "dorun", "(O)", cb_obj);
    Py_DECREF(cb_obj);
    int rc = 0;
    if (!ret)
    {
        set_err_from_python(err_buf);
        rc = FABBER_ERR_FATAL;
    }
    else
    {
        const char *log = PyUnicode_AsUTF8(ret);
        if (log && log_buf && log_bufsize > 0)
        {
            strncpy(log_buf, log, log_bufsize - 1);
            log_buf[log_bufsize - 1] = 0;
        }
        Py_DECREF(ret);
    }
    PyGILState_Release(gil);
    return rc;
}

int fabber_get_options(void *fab, const char *key, const char *value,
    unsigned int out_bufsize, char *out_buf, char *err_buf)
{
    return call_str_method(fab, out_bufsize, out_buf, err_buf, "get_options",
        "(ss)", key ? key : "", value ? value : "");
}

int fabber_get_models(
    void *fab, unsigned int out_bufsize, char *out_buf, char *err_buf)
{
    return call_str_method(
        fab, out_bufsize, out_buf, err_buf, "get_models", NULL);
}

int fabber_get_methods(
    void *fab, unsigned int out_bufsize, char *out_buf, char *err_buf)
{
    return call_str_method(
        fab, out_bufsize, out_buf, err_buf, "get_methods", NULL);
}

int fabber_get_model_params(
    void *fab, unsigned int out_bufsize, char *out_buf, char *err_buf)
{
    return call_str_method(
        fab, out_bufsize, out_buf, err_buf, "get_model_params", NULL);
}

int fabber_get_model_param_descs(
    void *fab, unsigned int out_bufsize, char *out_buf, char *err_buf)
{
    return call_str_method(
        fab, out_bufsize, out_buf, err_buf, "get_model_param_descs", NULL);
}

int fabber_get_model_outputs(
    void *fab, unsigned int out_bufsize, char *out_buf, char *err_buf)
{
    return call_str_method(
        fab, out_bufsize, out_buf, err_buf, "get_model_outputs", NULL);
}

static int model_evaluate_impl(void *fab, unsigned int n_params, float *params,
    unsigned int n_ts, float *indata, const char *output_name, float *output,
    char *err_buf)
{
    FabberContext *fc = (FabberContext *)fab;
    if (!fc || !params || !output)
    {
        set_err(err_buf, "NULL context or buffers");
        return FABBER_ERR_FATAL;
    }
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject *pparams = PyBytes_FromStringAndSize(
        (const char *)params, (Py_ssize_t)n_params * sizeof(float));
    PyObject *pindata;
    if (indata)
        pindata = PyBytes_FromStringAndSize(
            (const char *)indata, (Py_ssize_t)n_ts * sizeof(float));
    else
    {
        pindata = Py_None;
        Py_INCREF(Py_None);
    }
    PyObject *ret = PyObject_CallMethod(fc->backend, "model_evaluate",
        "(OIOs)", pparams, n_ts, pindata, output_name ? output_name : "");
    Py_XDECREF(pparams);
    Py_DECREF(pindata);
    int rc = 0;
    if (!ret)
    {
        set_err_from_python(err_buf);
        rc = FABBER_ERR_FATAL;
    }
    else
    {
        char *bytes;
        Py_ssize_t nbytes;
        if (PyBytes_AsStringAndSize(ret, &bytes, &nbytes) == 0
            && nbytes == (Py_ssize_t)(n_ts * sizeof(float)))
            memcpy(output, bytes, nbytes);
        else
        {
            set_err(err_buf, "Model evaluate returned wrong size");
            rc = FABBER_ERR_FATAL;
        }
        Py_DECREF(ret);
    }
    PyGILState_Release(gil);
    return rc;
}

int fabber_model_evaluate(void *fab, unsigned int n_params, float *params,
    unsigned int n_ts, float *indata, float *output, char *err_buf)
{
    return model_evaluate_impl(
        fab, n_params, params, n_ts, indata, "", output, err_buf);
}

int fabber_model_evaluate_output(void *fab, unsigned int n_params,
    float *params, unsigned int n_ts, float *indata, const char *output_name,
    float *output, char *err_buf)
{
    return model_evaluate_impl(
        fab, n_params, params, n_ts, indata, output_name, output, err_buf);
}

} /* extern "C" */
